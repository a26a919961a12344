"""The benchmark of the PyTorch and CUDA port (``tvc_ai_torch``).

Run one cell from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints one JSON line last on standard output. The cells, configurations
and metrics are listed in ``BENCHMARK.json``; each has its files here
(``configs/``, ``traffic/``, ``limits/``, ``metrics/``), and each traffic
names the program's entry it drives (``entries/``). ``reference/`` is the
plain PyTorch reference that decides ``correct``, ``yardsticks.py`` the
frozen work counts and peaks, ``readings.py`` the script that reads the
numbers the limits are set from. Nothing here imports JAX or the JAX package.
"""
