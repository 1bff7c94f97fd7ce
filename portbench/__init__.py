"""The benchmark of the PyTorch and CUDA port (``cellulus_tpu_torch``).

One run of one cell: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``).
"""
