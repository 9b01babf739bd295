"""The benchmark of spartan_parallel_tpu_torch on one NVIDIA card.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once; see README.md.
"""
