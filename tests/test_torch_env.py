"""The CPU settings that every port test file shares, and the check that each takes them.

The suite runs its files in several worker processes on one CPU, so each process
keeps one intra-op thread: more only contend for the same cores.  Every other
``tests/test_torch_*.py`` imports this module, so a file run alone gets the setting
it has in the suite, and the test below fails for a new file that leaves it out.
"""

from __future__ import annotations

from pathlib import Path

import torch

torch.set_num_threads(1)

IMPORT = "import tests.test_torch_env"


def test_every_port_test_file_takes_the_settings():
    here = Path(__file__).resolve()
    missing = [p.name for p in sorted(here.parent.glob("test_torch_*.py"))
               if p != here and not any(line.startswith(IMPORT)
                                        for line in p.read_text().splitlines())]
    assert not missing
    assert torch.get_num_threads() == 1
