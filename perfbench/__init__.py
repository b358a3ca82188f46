"""The benchmark of the PyTorch/CUDA port (``repro_torch``): ``python3 -m
perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
see ``run.py``."""
