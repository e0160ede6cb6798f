"""The benchmark of ``nnstreamer_tpu_torch`` on an NVIDIA card: ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the root of a checkout (see ``harness.py``)."""
