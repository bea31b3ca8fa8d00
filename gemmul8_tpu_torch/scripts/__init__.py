"""The sweep, scale, profile and weak-scaling drivers of the port.

Counterparts of the JAX package's `scripts/` drivers, each run as

    python -m gemmul8_tpu_torch.scripts.<name> [arguments]

with the JAX script's positional arguments and defaults, and each with a
`main(argv=None)` that tests call:

    accuracy_sweep   scripts/accuracy_sweep_tpu.py (--device cuda, the
                     default) and accuracy_sweep_cpu.py (--device cpu)
    band_seed_sweep  scripts/band_seed_sweep.py
    time_sweep       scripts/time_sweep_tpu.py
    scale_bench      scripts/scale_bench.py
    profile_phases   scripts/profile_phases.py
    weak_scaling     scripts/weak_scaling.py
    evidence         scripts/run_evidence.sh
    tune_matmul      scripts/tune_matmul.py ([n=8192] [L=14])
    tune_kernels     scripts/tune_kernels.py ([n=8192] [L=14]
                     [which=all|stats|encode|fusedenc|mmpipe|recon|matmul])

They drive `bench/harness.py` and `api.gemm` and write the harness's CSVs
(its schema and file names) to `results_torch/` by default; the two
tuners print their rows (each candidate launch entry built into a library
of its own under `build/kernels/`, held to the table library's bits and
timed beside its entry) and write no file. Every timed
row runs on the card only (`bench.timing.require_gpu` exits nonzero
without one); only the accuracy drivers take `--device cpu`, and the weak
scaling driver runs on gloo CPU ranks with it. Plots come from the JAX
package's `scripts/plot_results.py`, which reads these CSVs where
matplotlib is installed.
"""

RESULTS_DIR = "results_torch"
