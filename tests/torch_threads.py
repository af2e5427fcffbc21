"""Imported by every tests/test_torch_*.py before its work: caps torch's
intra-op threads at one share of the machine's cores per pytest-xdist
worker (PYTEST_XDIST_WORKER_COUNT), so that the workers' torch pools do not
oversubscribe the cores (6 workers × 8 threads on 8 cores by default). A
run in one process keeps every core."""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
