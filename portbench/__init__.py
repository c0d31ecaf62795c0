"""The benchmark of the PyTorch/CUDA port (``intool_rag_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that measures lives here: the traffic
generator, the input generators, the operation and byte counts, the trace
reduction, the plain reference and the comparison that decides
``correct``. From the port the harness takes only the system under test.
"""
