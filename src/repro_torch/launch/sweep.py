"""Co-design sweep launcher for the PyTorch port: the batched sweep of
``core/sweep.py`` over circuit variants × T_INTG (paper Fig 2/4, Table
1), writing one ``p2m-codesign-sweep/v3`` artifact (docs/sweep.md).

``--axes`` activates any of ``mismatch`` / ``v-threshold`` / ``sigma`` /
``n-sub`` with its registry default values (``core/variant_grid.py``);
each axis also has an explicit value flag. ``--protocol`` picks phase 2:
``frozen``, ``unfrozen`` or ``both`` (one shared pretrain). It runs on
``--device`` (default ``cuda``) and writes under
``artifacts/sweep_torch/`` unless ``--out`` says otherwise:

  python -m repro_torch.launch.sweep --grid fast
  python -m repro_torch.launch.sweep --grid fast --protocol frozen --device cpu
  python -m repro_torch.launch.sweep --grid fast --dataset dvs128 \\
      --data-root DIR
  python -m repro_torch.launch.sweep --grid paper --circuits a c \\
      --t-intg 1 10 100 1000 --mismatch 0.02 0.06

``--devices N`` shards the stacked variant axis (``core/sweep_exec.py``;
the artifact records ``devices``). A T_INTG that does not divide the
backbone's coarse window, or more ``--devices`` than there are visible
cards, exits with code 2 before any compute.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path


def run_codesign_grid(args) -> int:
    from repro_torch.core import sweep as engine
    from repro_torch.core import variant_grid
    from repro_torch.core.leakage import CircuitConfig
    from repro_torch.core.sweep_exec import make_executor
    from repro_torch.data import sources as sources_mod

    fast = args.grid == "fast"
    try:
        data, model, sweep_cfg, grid = engine.paper_setup(
            fast=fast, hw=args.hw, dataset=args.dataset,
            data_root=args.data_root)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # file-backed datasets evaluate on the held-out split, so records'
    # accuracies are out of sample (synthetic streams have no split)
    eval_data, eval_split = sources_mod.resolve_eval_dataset(
        args.dataset, hw=args.hw, data_root=args.data_root)
    if eval_split == "train":
        print("note: val split of the dataset is empty — evaluating on "
              "the training split", file=sys.stderr)
    if args.circuits:
        grid = replace(grid, circuits=tuple(
            CircuitConfig(c) for c in args.circuits))
    if args.t_intg:
        grid = replace(grid, t_intg_grid_ms=tuple(sorted(args.t_intg)))

    # variant axes: an explicit value flag wins; --axes <name> activates
    # the axis with its registry default values
    explicit = {"null_mismatch": args.mismatch,
                "v_threshold": args.v_threshold,
                "sigma": args.sigma,
                "n_sub": args.n_sub}
    active = {variant_grid.axis("null-mismatch" if n == "mismatch" else n
                                ).name for n in (args.axes or [])}
    overrides = {}
    for name, vals in explicit.items():
        if vals is None and name in active:
            vals = variant_grid.axis(name).cli_defaults
        if vals is not None:
            try:
                overrides[name] = variant_grid.check_values(name, vals)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
    grid = replace(grid, **overrides)
    mismatch_requested = args.mismatch is not None or \
        "null_mismatch" in active
    if mismatch_requested and CircuitConfig.NULLIFIED not in grid.circuits:
        print("note: the mismatch axis only affects circuit (c), which is "
              "not in this grid — values ignored", file=sys.stderr)

    for t in grid.t_intg_grid_ms:
        g = model.coarse_window_ms / t
        if abs(g - round(g)) > 1e-6:
            print(f"error: --t-intg {t:g} must divide the backbone coarse "
                  f"window ({model.coarse_window_ms:g} ms)", file=sys.stderr)
            return 2

    protocols = engine.resolve_protocols(args.protocol)
    try:
        executor = make_executor(args.devices, device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    t0 = time.time()
    results = engine.run_protocols(data, model, sweep_cfg, grid,
                                   protocols=protocols, executor=executor,
                                   eval_data=eval_data, device=args.device)
    wall_s = time.time() - t0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"codesign_grid_{args.grid}.json"
    artifact = engine.protocols_artifact(results, extra_meta={
        "wall_s": wall_s,
        "devices": executor.devices,
        "data": {"name": data.name, "dataset": args.dataset,
                 "data_root": args.data_root, "hw": data.height,
                 "n_classes": data.n_classes,
                 "duration_ms": data.duration_ms,
                 "eval_split": eval_split},
        "sweep": {"batch_size": sweep_cfg.batch_size,
                  "pretrain_steps": sweep_cfg.pretrain_steps,
                  "finetune_steps": sweep_cfg.finetune_steps,
                  "eval_batches": sweep_cfg.eval_batches},
    })
    path.write_text(json.dumps(artifact, indent=2))

    first = next(iter(results.values()))
    print(f"\n=== co-design grid sweep ({len(first.labels)} circuit cfgs "
          f"× {len(grid.t_intg_grid_ms)} T_INTG × "
          f"{'/'.join(protocols)}, {wall_s:.0f}s) ===")
    print(f"{'protocol':>9} {'config':>10} {'T_INTG':>8} {'acc':>6} "
          f"{'bw':>7} {'energy':>8} {'ret_mV':>8}")
    for proto, result in results.items():
        for r in result.records:
            print(f"{proto:>9} {r['label']:>10} {r['t_intg_ms']:6.0f}ms "
                  f"{r['accuracy']:6.3f} {r['bandwidth_norm']:6.2f}x "
                  f"{r['energy_improvement']:7.2f}x "
                  f"{r['retention_err_v'] * 1e3:8.2f}")
    print(f"artifact: {path}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun-cells", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--grid", type=str, default="paper",
                    choices=["paper", "fast"],
                    help="co-design grid preset (default: paper = 3 "
                         "circuits × 4 T_INTG)")
    ap.add_argument("--circuits", type=str, nargs="+", default=None,
                    choices=["a", "b", "c"], help="override circuit configs")
    ap.add_argument("--t-intg", type=float, nargs="+", default=None,
                    help="override T_INTG grid (ms)")
    ap.add_argument("--axes", type=str, nargs="+", default=None,
                    choices=["mismatch", "null-mismatch", "v-threshold",
                             "sigma", "n-sub"],
                    help="activate variant axes with their registry default "
                         "values (core/variant_grid.py); explicit value "
                         "flags below override")
    ap.add_argument("--mismatch", type=float, nargs="+", default=None,
                    help="nullifier mismatch values for circuit (c)")
    ap.add_argument("--v-threshold", type=float, nargs="+", default=None,
                    help="comparator threshold values (V), every circuit")
    ap.add_argument("--sigma", type=float, nargs="+", default=None,
                    help="process-variation sigma values on the leak taus")
    ap.add_argument("--n-sub", type=int, nargs="+", default=None,
                    help="event sub-slots per window (outer loop with "
                         "T_INTG)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the stacked variant axis over this many "
                         "devices (cuda:0 ... cuda:N-1, or N host shards "
                         "with --device cpu); records equal --devices 1")
    ap.add_argument("--protocol", type=str, default="both",
                    choices=["frozen", "unfrozen", "both"],
                    help="phase-2 protocol(s): frozen layer 1 (paper §3), "
                         "unfrozen joint training, or both off one shared "
                         "pretrain")
    ap.add_argument("--dataset", type=str, default="synthetic-gesture",
                    choices=["synthetic-gesture", "synthetic-nmnist",
                             "dvs128", "nmnist"],
                    help="event source (data/sources.py); dvs128 and "
                         "nmnist read --data-root")
    ap.add_argument("--data-root", type=str, default=None,
                    help="dataset directory for the file-backed datasets")
    ap.add_argument("--hw", type=int, default=16,
                    help="event-frame resolution")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", type=str, default="artifacts/sweep_torch")
    args = ap.parse_args(argv)

    if args.dryrun_cells:
        raise NotImplementedError(
            "the dry-run cell sweep (launch/dryrun*.py) comes with a later "
            "slice of the PyTorch port (ROADMAP.md queue 1 item 2c)")
    return run_codesign_grid(args)


if __name__ == "__main__":
    sys.exit(main())
