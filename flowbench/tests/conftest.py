"""The benchmark's tests import ``flowbench`` and the program from the
checkout's root, and keep torch to two threads a process: several pytest
workers at torch's default (one thread a core each) starve one another
on the CPU runs of the harness."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)
