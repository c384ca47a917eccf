"""End-to-end pose-graph sparsification experiment on the PyTorch port
(mac_tpu_torch's counterpart of the JAX package's examples/g2o_experiment.py,
with the same arguments and outputs).

For a g2o dataset: parse, split odometry/loop closures, sweep candidate
budgets, solve with MAC (nearest + Madow re-rounding), NaiveGreedy, and
optionally lazy GreedyESP; report lambda2, dual gaps, and timings; and, if
PySESync is installed, solve the sparsified SLAM problems and report
ATE/RPE against the full solution. Plots are written when matplotlib is
available and --plot is passed. The solvers run on the CUDA device unless
--cpu is given.

Usage (from the root of a checkout):
    python -m mac_tpu_torch.examples.g2o_experiment data/intel.g2o [--run-greedy] [--plot] [--cpu]
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

from mac_tpu_torch.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
from mac_tpu_torch.solvers import MAC, NaiveGreedy
from mac_tpu_torch.solvers.greedy_esp import GreedyESP
from mac_tpu_torch.utils.graphs import select_edges

# Optional downstream SLAM solver (external C++ dep, eval-quality only —
# reference guards this the same way, g2o_experiment.py:21).
try:
    import PySESync  # noqa: F401

    HAVE_SESYNC = True
except ImportError:
    HAVE_SESYNC = False


def sesync_solve(measurements, num_poses):
    """Solve the pose graph with SE-Sync; returns the xhat variable matrix."""
    import PySESync

    d = measurements[0].R.shape[0]
    sesync_measurements = []
    for m in measurements:
        meas = PySESync.RelativePoseMeasurement()
        meas.i = m.i
        meas.j = m.j
        meas.t = m.t
        meas.R = m.R
        meas.kappa = m.kappa
        meas.tau = m.tau
        sesync_measurements.append(meas)
    opts = PySESync.SESyncOpts()
    opts.num_threads = 4
    opts.verbose = False
    result = PySESync.SESync(sesync_measurements, opts)
    return np.asarray(result.xhat)


def main(argv=None):
    """Run the experiment on the command line's arguments (or `argv`);
    returns the per-budget records, selections included."""
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", help="path to .g2o file")
    ap.add_argument("--run-greedy", action="store_true", help="also run lazy GreedyESP")
    ap.add_argument("--budgets", default="0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8,0.9,1.0")
    ap.add_argument("--max-iters", type=int, default=20)
    ap.add_argument("--madow-trials", type=int, default=1)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plot-trajectory-grid", action="store_true",
                    help="with --plot and SE-Sync available: render the "
                         "full per-budget x per-method trajectory grid "
                         "(reference g2o_experiment.py:525-598)")
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--cpu", action="store_true",
                    help="run the solvers on the CPU (device=\"cpu\") "
                         "instead of the CUDA device")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    t0 = time.perf_counter()
    measurements, n = read_g2o_file(args.dataset)
    print(f"parsed {args.dataset}: {len(measurements)} measurements, "
          f"{n} poses in {time.perf_counter() - t0:.2f}s")

    fixed_meas, lc_meas = split_edges(rpm_to_mac(measurements))
    meas_fixed, meas_lc = split_edges(measurements)
    print(f"odometry edges: {len(fixed_meas)}, loop closures: {len(lc_meas)}")

    budgets = [float(b) for b in args.budgets.split(",")]
    ks = sorted({max(1, int(b * len(lc_meas))) for b in budgets})

    mac = MAC(fixed_meas, lc_meas, n, device=device)
    naive = NaiveGreedy(lc_meas)

    records = []
    for k in ks:
        x_init = naive.subset(k)
        rec = dict(k=k, pct=k / len(lc_meas))

        t0 = time.perf_counter()
        rounded, unrounded, upper, rt = mac.solve(
            k, x_init, rounding="nearest", max_iters=args.max_iters,
            use_cache=True, return_rounding_time=True,
        )
        rec["mac_nearest_s"] = time.perf_counter() - t0
        rec["mac_rounding_s"] = rt
        rec["lam2_mac_nearest"] = mac.evaluate_objective(rounded)
        rec["lam2_unrounded"] = mac.evaluate_objective(unrounded)
        rec["dual_upper"] = upper
        rec["lam2_naive"] = mac.evaluate_objective(x_init)
        rec["mac_selection"] = rounded.tolist()
        rec["naive_selection"] = x_init.tolist()

        # Madow re-rounding of the same relaxed solution; timing bookkeeping
        # mirrors the reference (g2o_experiment.py:327-336): FW time +
        # re-rounding time.
        t0 = time.perf_counter()
        xs = mac._madow_samples(unrounded, k, 0, args.madow_trials)
        if args.madow_trials > 1:
            vals = mac._eval_many_impl(mac._params, xs, mac._X0)
            madow = xs[int(np.argmax(vals))]
        else:
            madow = xs[0]
        rec["mac_madow_s"] = rec["mac_nearest_s"] - rt + (time.perf_counter() - t0)
        rec["lam2_mac_madow"] = mac.evaluate_objective(madow)
        rec["madow_selection"] = madow.tolist()

        print(
            f"k={k} ({rec['pct']:.0%}): naive={rec['lam2_naive']:.6g} "
            f"mac={rec['lam2_mac_nearest']:.6g} madow={rec['lam2_mac_madow']:.6g} "
            f"relaxed={rec['lam2_unrounded']:.6g} upper={upper:.6g} "
            f"[{rec['mac_nearest_s']:.2f}s]"
        )
        records.append(rec)

    if args.run_greedy:
        esp = GreedyESP(fixed_meas, lc_meas, n, device=device)
        t0 = time.perf_counter()
        results, _, times = esp.subsets_lazy(ks, verbose=False)
        for rec, mask, t in zip(records, results, times):
            rec["esp_s"] = t
            rec["lam2_esp"] = mac.evaluate_objective(mask)
            rec["esp_selection"] = mask.tolist()
            print(f"k={rec['k']}: esp={rec['lam2_esp']:.6g} [{t:.2f}s cumulative]")

    if HAVE_SESYNC:
        from mac_tpu_torch.slam.metrics import (
            poses_ate_tran,
            poses_rpe_rot,
            rotations_from_variable_matrix,
        )
        from mac_tpu_torch.slam.sesync_eval import (
            construct_LGrho,
            construct_sesync_quadratic_form_matrix,
            evaluate_sesync_objective,
            evaluate_sesync_rotation_objective,
            orbit_distance_dS,
        )

        # Full-measurement quality yardsticks (reference:
        # g2o_experiment.py:470-472, 50-91, 93-180, 23-48). LGrho and M are
        # built from the FULL measurement set: every sparsified solution is
        # scored against the complete problem's objective.
        LGrho_full = construct_LGrho(measurements)
        M_full = construct_sesync_quadratic_form_matrix(measurements)
        t0 = time.perf_counter()
        xhat_full = sesync_solve(measurements, n)
        full_sesync_s = time.perf_counter() - t0
        R_full = rotations_from_variable_matrix(xhat_full)
        full_objective = evaluate_sesync_objective(M_full, xhat_full)
        full_rot_cost = evaluate_sesync_rotation_objective(LGrho_full, R_full)
        print(f"full SE-Sync: objective={full_objective:.6g} "
              f"rot_cost={full_rot_cost:.6g} [{full_sesync_s:.2f}s]")

        xhats = {}  # (k, method) -> SE-Sync estimate, for trajectory grids
        for rec in records:
            rec["full_objective"] = full_objective
            rec["full_rot_cost"] = full_rot_cost
            for name in ("mac", "madow", "naive", "esp"):
                sel_key = f"{name}_selection" if name != "mac" else "mac_selection"
                if sel_key not in rec:
                    continue
                mask = np.asarray(rec[sel_key])
                sel_meas = meas_fixed + select_edges(meas_lc, mask)
                t0 = time.perf_counter()
                xhat = sesync_solve(sel_meas, n)
                rec[f"sesync_s_{name}"] = time.perf_counter() - t0
                xhats[(rec["k"], name)] = xhat
                rec[f"ate_{name}"] = poses_ate_tran(xhat, xhat_full)
                rec[f"rpe_{name}"] = poses_rpe_rot(xhat, xhat_full)
                # Score the sparsified solution on the FULL problem.
                rec[f"objective_{name}"] = evaluate_sesync_objective(M_full, xhat)
                Rm = rotations_from_variable_matrix(xhat)
                rec[f"rot_cost_{name}"] = evaluate_sesync_rotation_objective(
                    LGrho_full, Rm)
                rec[f"orbdist_{name}"] = orbit_distance_dS(R_full, Rm)
    else:
        print("PySESync not installed: skipping downstream SLAM quality eval")

    if args.out:
        slim = [{k: v for k, v in r.items() if not k.endswith("_selection")}
                for r in records]
        Path(args.out).write_text(json.dumps(slim, indent=2))
        print(f"wrote {args.out}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # Plot families mirror the reference experiment driver
        # (g2o_experiment.py:362-684): lambda2 + duality-gap band, solve
        # time, and — when SE-Sync ran — SE-Sync time, ATE, RPE, full
        # objective, rotation cost, SO(d) orbit distance, and trajectory
        # renders per method at the median budget.
        pcts = [r["pct"] for r in records]
        methods = [("naive", "Naive", "o-"), ("mac", "MAC (nearest)", "s-"),
                   ("madow", "MAC (madow)", "^-")]
        if "lam2_esp" in records[0]:
            methods.append(("esp", "GreedyESP", "d-"))

        def series(fmt):
            out = []
            for name, label, style in methods:
                key = fmt.format(name)
                if key in records[0]:
                    out.append((label, style, [r[key] for r in records]))
            return out

        have_q = "ate_mac" in records[0]
        nrow = 3 if have_q else 1
        fig, axes = plt.subplots(nrow, 3, figsize=(16, 4.5 * nrow),
                                 squeeze=False)

        lam_keys = {"naive": "lam2_naive", "mac": "lam2_mac_nearest",
                    "madow": "lam2_mac_madow", "esp": "lam2_esp"}
        ax = axes[0][0]
        for name, label, style in methods:
            ax.plot(pcts, [r[lam_keys[name]] for r in records], style, label=label)
        ax.fill_between(pcts, [r["lam2_unrounded"] for r in records],
                        [r["dual_upper"] for r in records], alpha=0.2,
                        label="duality gap")
        ax.set_xlabel("fraction of loop closures kept")
        ax.set_ylabel(r"$\lambda_2(L)$")
        ax.legend()

        ax = axes[0][1]
        ax.semilogy(pcts, [r["mac_nearest_s"] for r in records], "s-", label="MAC")
        if "esp_s" in records[0]:
            ax.semilogy(pcts, [r["esp_s"] for r in records], "d-",
                        label="GreedyESP (cum.)")
        ax.set_xlabel("fraction of loop closures kept")
        ax.set_ylabel("solve time (s)")
        ax.legend()

        ax = axes[0][2]
        gap = [max(r["dual_upper"] - r["lam2_unrounded"], 0.0) /
               max(abs(r["dual_upper"]), 1e-300) for r in records]
        ax.semilogy(pcts, gap, "s-")
        ax.set_xlabel("fraction of loop closures kept")
        ax.set_ylabel("relative duality gap")

        if have_q:
            panels = [
                ("ate_{}", "ATE (translation)", axes[1][0], False),
                ("rpe_{}", "RPE (rotation, deg)", axes[1][1], False),
                ("sesync_s_{}", "SE-Sync solve time (s)", axes[1][2], True),
                ("objective_{}", "SE-Sync objective (full problem)",
                 axes[2][0], False),
                ("rot_cost_{}", "rotation cost (full LGrho)", axes[2][1], False),
                ("orbdist_{}", r"SO(d) orbit distance", axes[2][2], False),
            ]
            for fmt, ylabel, ax, logy in panels:
                for label, style, ys in series(fmt):
                    (ax.semilogy if logy else ax.plot)(pcts, ys, style, label=label)
                if fmt.startswith("objective") and "full_objective" in records[0]:
                    ax.axhline(records[0]["full_objective"], color="k", ls="--",
                               lw=1, label="full solution")
                if fmt.startswith("rot_cost") and "full_rot_cost" in records[0]:
                    ax.axhline(records[0]["full_rot_cost"], color="k", ls="--",
                               lw=1, label="full solution")
                ax.set_xlabel("fraction of loop closures kept")
                ax.set_ylabel(ylabel)
                ax.legend(fontsize=8)

        stem = Path(args.dataset).stem
        fig.savefig(f"{stem}_experiment.png", dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {stem}_experiment.png")

        if have_q:
            # Trajectory renders at the median budget (reference
            # g2o_experiment.py:525-598), full vs per-method estimates.
            from mac_tpu_torch.slam.pose_graph import plot_poses

            rec = records[len(records) // 2]
            fig2, axes2 = plt.subplots(1, len(methods) + 1,
                                       figsize=(4.5 * (len(methods) + 1), 4))
            plot_poses(xhat_full, measurements, show=False, ax=axes2[0])
            axes2[0].set_title("full")
            for axp, (name, label, _) in zip(axes2[1:], methods):
                sel_key = f"{name}_selection" if name != "mac" else "mac_selection"
                mask = np.asarray(rec[sel_key])
                sel_meas = meas_fixed + select_edges(meas_lc, mask)
                xhat = sesync_solve(sel_meas, n)
                plot_poses(xhat, sel_meas, show=False, ax=axp)
                axp.set_title(f"{label} ({rec['pct']:.0%})")
            fig2.savefig(f"{stem}_trajectories.png", dpi=120, bbox_inches="tight")
            plt.close(fig2)
            print(f"wrote {stem}_trajectories.png")

            # Per-method time breakdown over budgets (reference has
            # per-method time plots at g2o_experiment.py:400-414,455-467):
            # Frank-Wolfe solve vs rounding vs downstream SE-Sync.
            fig3, ax3 = plt.subplots(figsize=(7, 4.5))
            ax3.semilogy(pcts, [r["mac_nearest_s"] - r["mac_rounding_s"]
                                for r in records], "s-", label="MAC solve (FW)")
            ax3.semilogy(pcts, [max(r["mac_rounding_s"], 1e-6)
                                for r in records], "s--",
                         label="MAC rounding (nearest)")
            ax3.semilogy(pcts, [max(r["mac_madow_s"] - (r["mac_nearest_s"]
                                    - r["mac_rounding_s"]), 1e-6)
                                for r in records], "^--",
                         label="Madow re-rounding")
            if "esp_s" in records[0]:
                ax3.semilogy(pcts, [r["esp_s"] for r in records], "d-",
                             label="GreedyESP (cumulative)")
            for name, label, style in methods:
                key = f"sesync_s_{name}"
                if key in records[0]:
                    ax3.semilogy(pcts, [r[key] for r in records],
                                 style.replace("-", ":"),
                                 label=f"SE-Sync ({label})")
            ax3.set_xlabel("fraction of loop closures kept")
            ax3.set_ylabel("time (s)")
            ax3.legend(fontsize=8)
            fig3.savefig(f"{stem}_time_breakdown.png", dpi=120,
                         bbox_inches="tight")
            plt.close(fig3)
            print(f"wrote {stem}_time_breakdown.png")

        if have_q and args.plot_trajectory_grid:
            # Full per-budget x per-method trajectory grid (reference
            # g2o_experiment.py:525-598) from the SE-Sync estimates cached
            # during the metrics pass.
            from mac_tpu_torch.slam.pose_graph import plot_poses

            nrows = len(records)
            fig4, axes4 = plt.subplots(
                nrows, len(methods) + 1,
                figsize=(4.0 * (len(methods) + 1), 3.6 * nrows),
                squeeze=False)
            for r_i, rec in enumerate(records):
                plot_poses(xhat_full, measurements, show=False,
                           ax=axes4[r_i][0])
                axes4[r_i][0].set_title(f"full ({rec['pct']:.0%} row)")
                for axp, (name, label, _) in zip(axes4[r_i][1:], methods):
                    xh = xhats.get((rec["k"], name))
                    if xh is None:
                        axp.axis("off")
                        continue
                    sel_key = (f"{name}_selection" if name != "mac"
                               else "mac_selection")
                    mask = np.asarray(rec[sel_key])
                    sel_meas = meas_fixed + select_edges(meas_lc, mask)
                    plot_poses(xh, sel_meas, show=False, ax=axp)
                    axp.set_title(f"{label} ({rec['pct']:.0%})")
            fig4.savefig(f"{stem}_trajectory_grid.png", dpi=100,
                         bbox_inches="tight")
            plt.close(fig4)
            print(f"wrote {stem}_trajectory_grid.png")

    return records


if __name__ == "__main__":
    main()
