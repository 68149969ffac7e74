"""portbench: the benchmark of the PyTorch and CUDA port ``corona13_tpu_torch``.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.  See README.md.
"""
