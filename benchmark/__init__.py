"""The benchmark of the PyTorch/CUDA port: ``python3 benchmark/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line."""
