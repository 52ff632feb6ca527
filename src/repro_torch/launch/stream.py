"""Online streaming inference launcher for the PyTorch port: serve live
event streams (synthetic, or replayed from DVS128-Gesture / N-MNIST
files) through one P²M deployment with continuous batching, and write
the ``p2m-stream-serving/v5`` stats artifact.

The deployment is one of:

  * ``--checkpoint DIR``: a serving checkpoint written by either package;
    ``--artifact PATH`` cross-checks it against the sweep artifact it was
    deployed from;
  * ``--config full|reduced``: a fresh, seeded deployment of
    ``configs/p2m_dvs`` (untrained; serving speed needs no training);
  * neither: a fast co-design sweep trains in process
    (``stream.deploy.train_and_deploy``, ``keep_params=True``), deploys
    the best record for ``--protocol`` (``--deploy-t-intg`` pins its
    T_INTG) and serves it; ``--smoke`` cuts that sweep to the
    reference's smoke scale (T grid 100 and 1000 ms, deployed at 100 ms).

``--dataset dvs128|nmnist`` reads the files under ``--data-root``. Under
``--smoke`` with no ``--data-root`` (dvs128 is ``--smoke``'s default) a
miniature fixture of the dataset is written to a temporary directory
(``data/fixtures.py``; for dvs128 2 recordings of 6 gesture trials),
trained on, served and removed; without ``--smoke`` a file-backed
dataset with no ``--data-root`` exits 2.

``--registry CKPT [CKPT ...]`` serves a deployment registry of several
compat-equal checkpoints from one engine (entry name = the directory's
basename, the first is the default entry); ``--variants SPEC [...]`` gives
each stream a variant request, cycled round-robin: an entry name or a
``k=v[,k=v...]`` metadata matcher, resolved at admission (unresolvable
requests are rejected and counted). ``--adapt`` turns on per-lane online
adaptation (``--adapt-rule``, ``--adapt-lr``, ``--adapt-lr-theta``);
``--adapt-export DIR`` harvests every adapted lane into a delta checkpoint
``DIR/lane<N>``. ``--devices N`` shards the lane axis over N devices
(``stream/shard.py``: cuda:0 … cuda:N-1, or N host shards with
``--device cpu``); more than the visible cards exit 2 before any stream
is opened.

A ``ValueError`` or ``OSError`` past the argument checks (a bad
``--devices``, a checkpoint that does not match its sweep record, a
dataset the smoke grid does not fit) prints ``error: ...`` and exits 2,
as the reference's launcher does; a ``--smoke`` fixture is removed
either way.

It runs on ``--device`` (default ``cuda``; the kernels build into
``build/kernels/`` at first use).

  python -m repro_torch.launch.stream --config full --streams 16 --capacity 16
  python -m repro_torch.launch.stream --device cpu --config reduced --streams 4
  python -m repro_torch.launch.stream --smoke --device cpu --streams 2 \\
      --capacity 2
  python -m repro_torch.launch.stream --dataset dvs128 --data-root DIR \\
      --checkpoint ckpt_a --streams 16 --capacity 16
  python -m repro_torch.launch.stream --registry ckpt_a ckpt_b \\
      --variants ckpt_a circuit=b --streams 16 --capacity 16
  python -m repro_torch.launch.stream --checkpoint ckpt_a --adapt \\
      --adapt-lr 0.5 --adapt-export deltas --streams 16 --capacity 16
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path


def _parse_variant_spec(spec: str):
    """CLI variant request → registry request: a bare entry name, or a
    ``k=v[,k=v...]`` metadata matcher (values parsed as JSON scalars when
    possible, e.g. ``t_intg_ms=100.0``)."""
    if "=" not in spec:
        return spec
    matcher = {}
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        try:
            matcher[k] = json.loads(v)
        except json.JSONDecodeError:
            matcher[k] = v
    return matcher


def _make_fixture(dataset: str, root: Path) -> None:
    """``--smoke``'s fixture, at the reference's sizes."""
    from repro_torch.data import fixtures
    if dataset == "dvs128":
        fixtures.make_dvs128_fixture(root, n_recordings=2,
                                     trials_per_recording=6)
    else:
        fixtures.make_nmnist_fixture(root)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="serving checkpoint dir; omitted: a fresh seeded "
                         "deployment of --config, or without --config a "
                         "fast sweep trains and deploys one in process")
    ap.add_argument("--artifact", type=str, default=None,
                    help="sweep artifact JSON to cross-check the "
                         "checkpoint against")
    ap.add_argument("--config", choices=["full", "reduced"], default=None,
                    help="configs/p2m_dvs: the paper's CONFIG or reduced(), "
                         "as a fresh seeded deployment")
    ap.add_argument("--protocol", choices=["frozen", "unfrozen"],
                    default="frozen",
                    help="phase-2 protocol to train and deploy when no "
                         "--checkpoint or --config is given")
    ap.add_argument("--deploy-t-intg", type=float, default=None,
                    help="pin the deployed record's T_INTG (ms); default: "
                         "best accuracy on the trained grid")
    ap.add_argument("--hw", type=int, default=16,
                    help="event-frame resolution of the trained deployment")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dataset", type=str, default=None,
                    choices=["synthetic-gesture", "synthetic-nmnist",
                             "dvs128", "nmnist"],
                    help="event source (default: dvs128 under --smoke, "
                         "served from a generated fixture, else "
                         "synthetic-gesture)")
    ap.add_argument("--data-root", type=str, default=None,
                    help="dataset directory for the file-backed datasets")
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
                    default=None,
                    help="streaming-fold kernel: conv deposits folded in "
                         "the kernel (the default), or the conv inside the "
                         "kernel; --adapt runs its own per-lane fold")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="artifacts/stream_torch")
    ap.add_argument("--registry", type=str, nargs="+", default=None,
                    metavar="CKPT",
                    help="serve a deployment registry of these checkpoint "
                         "dirs (entry name = dir basename; the first is the "
                         "default entry); excludes --checkpoint")
    ap.add_argument("--variants", type=str, nargs="+", default=None,
                    metavar="SPEC",
                    help="per-stream variant requests, cycled round-robin: "
                         "an entry name or a k=v[,k=v] metadata matcher "
                         "(requires --registry)")
    ap.add_argument("--max-entries", type=int, default=None,
                    help="registry engine param-table size (variants "
                         "co-resident on the lanes; default entries + 1)")
    ap.add_argument("--adapt", action="store_true",
                    help="per-lane online adaptation of the layer-1 "
                         "weights and threshold from each stream's labels")
    ap.add_argument("--adapt-rule", choices=["surrogate", "reward"],
                    default="surrogate",
                    help="surrogate-gradient descent, or reward-modulated "
                         "three-factor (eligibility traces)")
    ap.add_argument("--adapt-lr", type=float, default=5e-3,
                    help="weight-delta learning rate")
    ap.add_argument("--adapt-lr-theta", type=float, default=0.0,
                    help="comparator-threshold learning rate")
    ap.add_argument("--adapt-export", type=str, default=None, metavar="DIR",
                    help="harvest every adapted lane into a delta "
                         "checkpoint DIR/lane<N> (requires --adapt)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the lane axis over this many devices "
                         "(capacity is padded up to a multiple; "
                         "bit-identical to --devices 1). Default: "
                         "unsharded")
    ap.add_argument("--bin-workers", type=int, default=None,
                    help="host binning worker threads (default: one per "
                         "device)")
    ap.add_argument("--smoke", action="store_true",
                    help="train and deploy at the reference's smoke scale; "
                         "writes a fixture when a file-backed dataset has "
                         "no --data-root")
    args = ap.parse_args(argv)

    if args.registry is not None and args.checkpoint is not None:
        print("error: --registry and --checkpoint are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.variants is not None and args.registry is None:
        print("error: --variants requires --registry", file=sys.stderr)
        return 2
    if args.adapt_export is not None and not args.adapt:
        print("error: --adapt-export requires --adapt", file=sys.stderr)
        return 2

    from repro_torch.data import sources
    from repro_torch.stream.shard import make_lane_executor

    dataset = args.dataset or ("dvs128" if args.smoke
                               else "synthetic-gesture")
    data_root = args.data_root
    if dataset in sources.FILE_BACKED and data_root is None \
            and not args.smoke:
        print(f"error: dataset {dataset!r} is file-backed: pass "
              f"--data-root (or --smoke to generate a fixture)",
              file=sys.stderr)
        return 2
    fixture_tmp = None
    if dataset in sources.FILE_BACKED and data_root is None:
        fixture_tmp = tempfile.mkdtemp(prefix=f"p2m-{dataset}-fixture-")
        data_root = fixture_tmp
    try:
        executor = make_lane_executor(args.devices, device=args.device)
        if fixture_tmp is not None:
            print(f"[stream] generating {dataset} fixture under {data_root}")
            _make_fixture(dataset, Path(fixture_tmp))
        return _serve(args, dataset, data_root, executor)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if fixture_tmp is not None:
            shutil.rmtree(fixture_tmp, ignore_errors=True)


def _serve(args, dataset: str, data_root: str | None, executor) -> int:
    """Build or load the deployment, serve ``args.streams`` streams of
    ``dataset``, write the artifact and print its summary."""
    from repro_torch.configs import p2m_dvs
    from repro_torch.data import sources
    from repro_torch.stream import deploy
    from repro_torch.stream.adapt import AdaptConfig
    from repro_torch.stream.engine import StreamEngine
    from repro_torch.stream.registry import Registry

    out = Path(args.out)
    default_entry = None
    duration = args.duration_ms
    if args.registry is not None:
        target = Registry()
        for d in args.registry:
            entry = target.register_checkpoint(
                Path(d).name, d, artifact=args.artifact,
                device=args.device)
            print(f"[registry] {entry.name}#{entry.uid} "
                  f"({entry.meta.get('label')}/"
                  f"{entry.meta.get('protocol')} "
                  f"T={entry.meta.get('t_intg_ms'):g}ms, compat "
                  f"{entry.compat_digest})")
        default_entry = target.names()[0]
        dep = target.get(default_entry).dep
    elif args.checkpoint is not None:
        dep = target = deploy.load_deployment(
            args.checkpoint, device=args.device, artifact=args.artifact)
    elif args.config is not None and not args.smoke:
        cfg, data = ((p2m_dvs.CONFIG, p2m_dvs.DATA)
                     if args.config == "full" else p2m_dvs.reduced())
        dep = target = deploy.fresh_deployment(cfg, seed=args.seed,
                                               device=args.device)
        duration = args.duration_ms or data.duration_ms
    else:
        bundle = deploy.train_and_deploy(
            out / "deploy", dataset=dataset, data_root=data_root, hw=args.hw,
            protocols=(args.protocol,), smoke=args.smoke,
            t_intg_grid_ms=(100.0, 1000.0) if args.smoke else None,
            deploy_t_intg_ms=(args.deploy_t_intg if args.deploy_t_intg
                              is not None else
                              (100.0 if args.smoke else None)),
            device=args.device)
        dep = target = deploy.load_deployment(
            bundle["checkpoints"][args.protocol], device=args.device,
            artifact=bundle["artifact"])
    source = sources.resolve_dataset(
        dataset, hw=dep.model_cfg.backbone.input_hw[0],
        duration_ms=duration, data_root=data_root, split="all")
    adapt = (AdaptConfig(rule=args.adapt_rule, lr_w=args.adapt_lr,
                         lr_theta=args.adapt_lr_theta)
             if args.adapt else None)
    engine = StreamEngine(target, capacity=args.capacity,
                          chunks_per_window=args.chunks_per_window,
                          fold_mode=args.fold_mode, device=args.device,
                          executor=executor,
                          bin_workers=args.bin_workers,
                          max_entries=args.max_entries,
                          default_entry=default_entry, adapt=adapt)
    variants = None
    if args.variants is not None:
        reqs = [_parse_variant_spec(v) for v in args.variants]
        variants = lambda sid: reqs[sid % len(reqs)]  # noqa: E731
    report = engine.serve(source, args.streams, seed=args.seed,
                          paced=args.paced,
                          offered_rate=args.offered_rate,
                          max_pending=args.max_pending,
                          variants=variants, log=print)

    art = report.to_artifact()
    art["data"] = {"dataset": dataset, "data_root": data_root,
                   "hw": source.height,
                   "n_classes": source.n_classes,
                   "duration_ms": source.duration_ms}
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"stream_serving_{dataset}.json"
    path.write_text(json.dumps(art, indent=2, default=float))

    lat, thr, adm = art["latency_ms"], art["throughput"], art["admission"]
    print(f"\n=== stream serving on {art['device']} ({art['n_streams']} "
          f"streams, {report.capacity} lanes, T_INTG={art['t_intg_ms']:g}ms, "
          f"fold {engine.fold_mode or 'per-lane (adapt)'}"
          f"{', paced' if art['paced'] else ''}) ===")
    print(f"accuracy       {art['accuracy']:.3f}")
    print(f"readout p50    {lat['readout_p50']:.2f} ms   "
          f"p99 {lat['readout_p99']:.2f} ms")
    print(f"fold p50       {lat['fold_p50']:.2f} ms   "
          f"p99 {lat['fold_p99']:.2f} ms")
    print(f"throughput     {thr['events_per_s']:.0f} events/s   "
          f"{thr['readouts_per_s']:.1f} readouts/s   wall "
          f"{thr['wall_s']:.2f} s")
    sh = art["sharding"]
    print(f"sharding       {sh['devices']} device(s) x "
          f"{sh['lanes_per_shard']} lanes  (padded capacity "
          f"{sh['padded_capacity']}, {sh['bin_workers']} bin worker(s))   "
          f"{thr['events_per_s_per_device']:.0f} events/s/device")
    print(f"admission      offered {adm['n_offered']}  admitted "
          f"{adm['n_admitted']}  shed {adm['n_shed']}  rejected "
          f"{adm['n_rejected']}  deferred {adm['n_deferred']}  max open "
          f"{adm['max_open_streams']}")
    if args.registry is not None:
        for row in art["registry"]["entries"]:
            print(f"variant        {row['name']}#{row['uid']}  admitted "
                  f"{row['n_admitted']}  finished {row['n_finished']}  "
                  f"acc {row['accuracy']:.3f}  "
                  f"{row['events_per_s']:.0f} events/s")
    if art["paced"]:
        ddl = art["deadlines"]
        print(f"deadlines      {ddl['n_misses']}/{ddl['n_deadlines']} missed "
              f"({ddl['miss_rate']:.2%})")
    ad = art["adaptation"]
    if ad["enabled"]:
        fmt = lambda a: "-" if a is None else f"{a:.3f}"  # noqa: E731
        print(f"adaptation     {ad['rule']}  lr_w {ad['lr_w']:g}  "
              f"{ad['n_updates']} updates on {len(ad['lanes'])} lane(s)   "
              f"acc pre {fmt(ad['accuracy_pre'])} -> "
              f"post {fmt(ad['accuracy_post'])}")
        if args.adapt_export is not None:
            for row in ad["lanes"]:
                h = engine.harvest(row["lane"])
                d = Path(args.adapt_export) / f"lane{row['lane']}"
                deploy.save_adapt_delta(
                    d, h["base"], dw=h["dw"], dtheta=h["dtheta"],
                    base_name=h["base_name"], base_uid=h["base_uid"],
                    lane=h["lane"], n_updates=h["n_updates"],
                    rule=args.adapt_rule, meta={"dataset": dataset})
                print(f"[adapt] lane {row['lane']}: {h['n_updates']} "
                      f"updates on base {h['base_name']}#{h['base_uid']} "
                      f"-> {d}")
    print(f"artifact: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
