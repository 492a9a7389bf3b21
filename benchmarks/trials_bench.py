"""Trial-parallel adaptive-inference throughput (reference perf_test_multiple).

The reference fans independent inference trials out over ipyparallel
engines (``src/qinfer/perf_testing.py::perf_test_multiple(apply=view.apply)``).
The single-program replacement is :func:`qinfer_tpu.perf_testing.
perf_test_scan_batch`, which offers two modes measured here:

* ``sequential`` — a 1-device trial mesh (``lax.map`` over trials inside
  ``shard_map``): each trial keeps REAL conditional resampling, so
  per-trial cost matches the single-trial path; aggregate throughput is
  ~linear in trials (this is also the multi-chip scale-out mode: one
  trial block per device).
* ``vmap`` — trials batched into one program: every engine op runs at
  ``trials x particles`` batch (better device utilization), but the
  0/1-trip resample ``while_loop`` vmaps to a select-masked body that
  executes whenever ANY trial's ESS predicate fires — with 32
  independent trials some trial resamples almost every step, so in
  practice every step pays the full-batch resample cost.

The interesting question this script answers with data: at which ensemble
size does vmap's batching win over its forced-resample penalty?

Usage:
    python benchmarks/trials_bench.py                 # default backend
    python benchmarks/trials_bench.py --cpu --trials 4 --particles 4096
Prints one JSON line per run.
"""

import argparse
import json
import os
import sys
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--trials", type=int, default=32)
    parser.add_argument("--particles", type=int, default=2 ** 17)
    parser.add_argument("--steps", type=int, default=256)
    parser.add_argument("--modes", default="baseline,sequential,vmap",
                        help="comma list of baseline|sequential|vmap")
    parser.add_argument("--fill", default=None,
                        choices=[None, "gather", "scan", "telescope"],
                        help="override the resample fill strategy")
    parser.add_argument("--interval", type=int, default=0,
                        help="resample_interval: check the ESS gate only "
                        "every K steps (0 = every step). Synchronizes "
                        "vmapped trials' resample-eligible steps, "
                        "bounding the select-masked resample body to "
                        "steps/K executions (VERDICT r3 #8)")
    args = parser.parse_args()

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax

    from qinfer_tpu._cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh

    import qinfer_tpu as q
    from qinfer_tpu.perf_testing import perf_test_scan_batch
    from qinfer_tpu.resamplers import LiuWestResampler

    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    n, n_exp = args.particles, args.steps

    def run(tag, n_trials, mesh, resampler):
        runner, keys = perf_test_scan_batch(
            model, n, prior, n_exp, n_trials, mesh=mesh,
            resampler=resampler, seed=11,
            resample_interval=args.interval, return_runner=True)
        rec = jax.block_until_ready(runner(keys))   # compile + warm
        t0 = time.perf_counter()
        rec = jax.block_until_ready(runner(keys))
        dt = time.perf_counter() - t0
        est = np.asarray(rec["est"][:, -1, :])
        true = np.asarray(rec["true_mps"])
        loss = np.asarray(rec["loss"])
        out = {
            "metric": f"trials_{tag}_aggregate_updates_per_s",
            "resample_interval": args.interval,
            "n_trials": n_trials,
            "n_particles": n,
            "n_steps": n_exp,
            "value": round(n_trials * n * n_exp / dt, 1),
            "per_trial_updates_per_s": round(n * n_exp * n_trials / dt
                                             / n_trials, 1),
            "wall_s": round(dt, 4),
            "median_abs_err_final": round(
                float(np.median(np.abs(est - true))), 6),
            "median_loss_ratio_final_vs_first": round(
                float(np.median(loss[:, -1] / np.maximum(loss[:, 0],
                                                         1e-30))), 6),
        }
        print(json.dumps(out), flush=True)
        return out

    results = []
    modes = args.modes.split(",")
    dev = jax.devices()[0]
    mesh1 = Mesh(np.asarray([dev]), ("trials",))

    if "baseline" in modes:
        # single trial through the SAME mesh/lax.map path: the fair
        # per-trial reference point for both parallel modes
        results.append(run("baseline1", 1, mesh1,
                           LiuWestResampler(fill_strategy=args.fill)))
    if "sequential" in modes:
        results.append(run("sequential", args.trials, mesh1,
                           LiuWestResampler(fill_strategy=args.fill)))
    if "vmap" in modes:
        results.append(run("vmap", args.trials, None,
                           LiuWestResampler(fill_strategy=args.fill)))
    return results


if __name__ == "__main__":
    main()
