"""Benchmark of the PyTorch and CUDA port (`sorting_fhe_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card and prints one
JSON line.  Everything that decides a number lives here: the cells'
files (configs/, traffic/), the metric readers (metrics/), the byte
counts and peaks (roofline/), the plain reference that decrypts and
judges every output (reference.py) and the control (control.py).  From
the port it takes only the system under test and its counters.
"""
