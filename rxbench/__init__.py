"""The benchmark of the PyTorch and CUDA port (`BENCHMARK.json`): raw
impaired DVB-T2 samples to transport-stream bytes on one H100.

    python3 -m rxbench.run --workload <cell> --seed <n> --seconds 45 --trace 0
"""
