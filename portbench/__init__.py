"""The benchmark of the PyTorch/CUDA port, ``subpixal_tpu_torch``: one
cell a run (``python3 portbench/run.py --workload <cell> ...``)."""
