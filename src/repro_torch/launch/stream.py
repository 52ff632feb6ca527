"""Online streaming inference launcher for the PyTorch port: serve live
synthetic event streams through one P²M deployment with continuous
batching, and write the ``p2m-stream-serving/v5`` stats artifact.

The deployment is ``--checkpoint DIR`` (a serving checkpoint written by
either package) or a fresh, seeded one of ``--config full|reduced``
(``configs/p2m_dvs``). It runs on ``--device`` (default ``cuda``; the
kernels build into ``build/kernels/`` at first use).

  python -m repro_torch.launch.stream --config full --streams 16 --capacity 16
  python -m repro_torch.launch.stream --device cpu --config reduced --streams 4
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with a later slice of the "
                               f"PyTorch port")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="serving checkpoint dir; omitted: a fresh seeded "
                         "deployment of --config")
    ap.add_argument("--config", choices=["full", "reduced"], default="full",
                    help="configs/p2m_dvs: the paper's CONFIG or reduced()")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dataset", type=str, default="synthetic-gesture",
                    choices=["synthetic-gesture", "synthetic-nmnist",
                             "dvs128", "nmnist"])
    ap.add_argument("--duration-ms", type=float, default=None,
                    help="stream duration (default: the config's DATA "
                         "duration, or 2000 ms with --checkpoint)")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4,
                    help="concurrent serving lanes")
    ap.add_argument("--paced", action="store_true",
                    help="real-time replay with deadline-miss accounting")
    ap.add_argument("--offered-rate", type=float, default=None,
                    help="offered load, streams/s on the replay clock")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound on the pending admission queue")
    ap.add_argument("--chunks-per-window", type=int, default=None,
                    help="replay chunks per T_INTG window (divides n_sub)")
    ap.add_argument("--fold-mode", choices=["deposit", "mac"],
                    default="deposit",
                    help="streaming-fold kernel: conv deposits folded in "
                         "the kernel, or the conv inside the kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="artifacts/stream_torch")
    ap.add_argument("--registry", nargs="+", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--adapt", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--devices", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.registry is not None:
        raise _later_slice("registry serving (stream/registry.py)")
    if args.adapt:
        raise _later_slice("online adaptation (stream/adapt.py)")
    if args.devices not in (None, 1):
        raise _later_slice("lane sharding (stream/shard.py)")
    if args.smoke:
        raise _later_slice("train-and-deploy (the training slice)")

    from repro_torch.configs import p2m_dvs
    from repro_torch.data import sources
    from repro_torch.stream import deploy
    from repro_torch.stream.engine import StreamEngine

    if args.checkpoint is not None:
        dep = deploy.load_deployment(args.checkpoint, device=args.device)
        duration = args.duration_ms
    else:
        cfg, data = ((p2m_dvs.CONFIG, p2m_dvs.DATA) if args.config == "full"
                     else p2m_dvs.reduced())
        dep = deploy.fresh_deployment(cfg, seed=args.seed, device=args.device)
        duration = args.duration_ms or data.duration_ms
    source = sources.resolve_dataset(args.dataset,
                                     hw=dep.model_cfg.backbone.input_hw[0],
                                     duration_ms=duration)
    engine = StreamEngine(dep, capacity=args.capacity,
                          chunks_per_window=args.chunks_per_window,
                          fold_mode=args.fold_mode, device=args.device)
    report = engine.serve(source, args.streams, seed=args.seed,
                          paced=args.paced, offered_rate=args.offered_rate,
                          max_pending=args.max_pending, log=print)

    art = report.to_artifact()
    art["data"] = {"dataset": args.dataset, "hw": source.height,
                   "n_classes": source.n_classes,
                   "duration_ms": source.duration_ms}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"stream_serving_{args.dataset}.json"
    path.write_text(json.dumps(art, indent=2, default=float))

    lat, thr, adm = art["latency_ms"], art["throughput"], art["admission"]
    print(f"\n=== stream serving on {art['device']} ({art['n_streams']} "
          f"streams, {report.capacity} lanes, T_INTG={art['t_intg_ms']:g}ms, "
          f"fold {args.fold_mode}{', paced' if art['paced'] else ''}) ===")
    print(f"accuracy       {art['accuracy']:.3f}")
    print(f"readout p50    {lat['readout_p50']:.2f} ms   "
          f"p99 {lat['readout_p99']:.2f} ms")
    print(f"fold p50       {lat['fold_p50']:.2f} ms   "
          f"p99 {lat['fold_p99']:.2f} ms")
    print(f"throughput     {thr['events_per_s']:.0f} events/s   "
          f"{thr['readouts_per_s']:.1f} readouts/s   wall "
          f"{thr['wall_s']:.2f} s")
    print(f"admission      offered {adm['n_offered']}  admitted "
          f"{adm['n_admitted']}  shed {adm['n_shed']}  deferred "
          f"{adm['n_deferred']}  max open {adm['max_open_streams']}")
    if art["paced"]:
        ddl = art["deadlines"]
        print(f"deadlines      {ddl['n_misses']}/{ddl['n_deadlines']} missed "
              f"({ddl['miss_rate']:.2%})")
    print(f"artifact: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
