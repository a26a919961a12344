"""Console-script entry points (pyproject ``[project.scripts]``).

``tvc-torch-train``, ``tvc-torch-evaluate`` and ``tvc-torch-export`` call the
port's own command-line modules (``python -m tvc_ai_torch.train``,
``.evaluate``, ``.export``) with the process's arguments, so an installed
package needs no ``scripts/`` directory.
"""

from __future__ import annotations


def train_main() -> int:
    from tvc_ai_torch.train import main

    return main()


def evaluate_main() -> int:
    from tvc_ai_torch.evaluate import main

    return main()


def export_main() -> int:
    from tvc_ai_torch.export.__main__ import main

    return main()
