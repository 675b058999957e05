"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one
cell at a time, ``python3 chipbench/run.py --workload <name> ...``."""
