"""The port tests' CPU thread rule: one intra-op thread a process.

Every ``tests/test_torch_port_*.py`` imports this module before its torch
work. The tier-1 suite runs six xdist workers on eight cores: with torch's
default of one thread a core, a worker's threads fight the other workers'
at every parallel region, and the port's many small CPU models make many
small regions. ``benchmark/run.py`` pins one thread for the same reason.

``os.environ`` carries the rule to the processes the tests start (the CLI
subprocesses, the spawned gloo ranks); ``torch.set_num_threads`` applies it
to this process, whatever torch had set before. A ``cuda``-marked test run
on the card (``--noconftest -m cuda``) gets one host thread too, as
intended: those tests time device work.
"""

import os

import torch

THREADS = 1

os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)
