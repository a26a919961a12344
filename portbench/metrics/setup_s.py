"""Set-up seconds: from the process's start to the end of the warm-up
(imports, the card's start-up, the weights and the first reset made from
the seed, the step kernel's build on a first run, the warm-up chunks)."""


def read(ctx):
    return ctx.setup_s
