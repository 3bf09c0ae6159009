"""The benchmark of `asset_asrl_torch` on an NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line.  Everything that belongs to one cell, configuration, metric or
reference is a file of its own, found by its name:

    workloads/<cell>.json      the cell's traffic and correctness limits
    configs/<config>.py        the problem as it is run (source, sizes)
    entries/<entry>.py         how the window drives the port
    metrics/<metric>.py        one reader per metric
    reference/<config>.py      the plain reference that judges answers

Importing this package imports nothing else.
"""
