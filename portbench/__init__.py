"""The benchmark of `cuda_surf_tpu_torch`, the PyTorch and CUDA port, on
NVIDIA cards.

One command runs one cell of `BENCHMARK.json` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel's work count is a file of its own, found by its name:
`configs/<config>.json`, `traffic/<mix>.json` (data, read by `traffic.py`),
`layer_metrics/<metric>.py`, `rooflines/<kernel>.py`, and the limits of a
cell's correctness check in `limits/<cell>.json`.  A mix names its scene,
`scenes/<scene>.py`, and its request form, `forms/<form>.py`, which drives
the program and judges a sampled request; a new scene or form is a new
file.  The plain reference lives in `reference/`; `faults.py` plants the
faults that the check must catch, and `calibrate.py` reads the limits'
readings.
"""
