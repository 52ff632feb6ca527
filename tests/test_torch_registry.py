"""PyTorch port: the deployment registry and multi-variant serving against
the JAX package, on the CPU at ``reduced()``.

Three compat-equal deployments (the paper's circuits a, b and c) written
by the JAX package are served by both packages from the same numpy-seeded
event records. Held to: the compat key string-equal to the reference's;
a mixed-variant serve's logits within 1e-4 of the reference's mixed
serve, predictions, entry bindings and rejections equal; inside the port,
the mixed serve bit-identical per stream to single-variant serves, a
hot-swap leaving the other lanes bit-identical.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import p2m_dvs as j_configs
from repro.stream import deploy as j_deploy
from repro.stream import registry as j_registry
from repro.stream.engine import StreamEngine as JaxEngine
from repro_torch.stream import deploy
from repro_torch.stream.engine import EntryTableFull, StreamEngine
from repro_torch.stream.registry import (Registry, compat_digest, compat_key,
                                         entry_meta)
from repro_torch.stream.shard import LaneExecutor, make_lane_executor
from stream_replay import (assert_logits_close, by_stream, jax_deployment,
                           replay_factory)
from torch_threads import one_torch_thread  # noqa: F401

HW, N_CLASSES, SLOT_US = 24, 11, 2500
CIRCUITS = {"a": dict(circuit=j_deploy.CircuitConfig.BASIC),
            "b": dict(circuit=j_deploy.CircuitConfig.SWITCH),
            "c": dict(circuit=j_deploy.CircuitConfig.NULLIFIED,
                      null_mismatch=0.06)}


@pytest.fixture(scope="module")
def jdeps():
    """The JAX package's deployments, one per paper circuit."""
    cfg, _ = j_configs.reduced()
    return {name: jax_deployment(j_deploy, cfg, seed, **leak)
            for seed, (name, leak) in enumerate(CIRCUITS.items())}


@pytest.fixture(scope="module")
def deps(jdeps, tmp_path_factory):
    """The same deployments, saved by the JAX package, loaded by the port."""
    out = {}
    for name, jd in jdeps.items():
        path = tmp_path_factory.mktemp(f"jax_{name}")
        j_deploy.save_deployment(path, jd)
        out[name] = deploy.load_deployment(path, device="cpu")
    return out


@pytest.fixture(scope="module")
def other_geometry(deps):
    """A deployment whose replay geometry (T_INTG) differs."""
    d = deps["a"]
    cfg = dataclasses.replace(d.model_cfg, p2m=dataclasses.replace(
        d.model_cfg.p2m, t_intg_ms=20.0))
    return deploy.fresh_deployment(cfg, seed=5, device="cpu")


def _registry(deps, names=("a", "b")):
    reg = Registry()
    for n in names:
        reg.register(n, deps[n])
    return reg


# ---------------------------------------------------------------------------
# CRUD, compat key, resolve
# ---------------------------------------------------------------------------

def test_register_retire_lookup_and_uids(deps):
    """CRUD, and hot-swap identity: re-registering a retired name yields a
    new uid; every mutation bumps ``version``."""
    reg = Registry()
    e = reg.register("a", deps["a"])
    assert e.name == "a" and e.uid == 0
    assert len(reg) == 1 and "a" in reg and reg.get("a") is e
    reg.register("b", deps["b"])
    assert reg.names() == ["a", "b"]
    assert [x.name for x in reg.entries()] == ["a", "b"]
    assert reg.retire("a") is e and "a" not in reg and len(reg) == 1
    e2 = reg.register("a", deps["c"])
    assert e2.uid == 2 and reg.version == 4


@pytest.mark.parametrize("call, err, match", [
    (lambda reg, d: reg.register("a", d), ValueError, "already exists"),
    (lambda reg, d: reg.register("", d), ValueError, "non-empty"),
    (lambda reg, d: reg.retire("nope"), KeyError, "no entry"),
    (lambda reg, d: reg.get("nope"), KeyError, "no entry"),
])
def test_crud_errors(deps, call, err, match):
    reg = _registry(deps, ("a",))
    with pytest.raises(err, match=match):
        call(reg, deps["b"])


def test_entry_is_self_describing(deps):
    e = Registry().register("a", deps["a"], meta={"site": "lab-3"})
    assert e.meta["circuit"] == "a"          # variant splatted flat
    assert e.meta["variant"]["circuit"] == "a"
    assert e.meta["protocol"] == deps["a"].protocol
    assert e.meta["site"] == "lab-3"         # caller meta overlays
    d = e.describe()
    assert d["name"] == "a" and d["uid"] == e.uid
    assert d["compat"] == compat_digest(e.compat)
    m = entry_meta(deps["a"])
    assert m["t_intg_ms"] == deps["a"].t_intg_ms
    assert m["n_sub"] == deps["a"].model_cfg.p2m.n_sub


def test_register_checkpoint_roundtrip(deps, tmp_path):
    deploy.save_deployment(tmp_path, deps["a"])
    e = Registry().register_checkpoint("ck", tmp_path, device="cpu")
    assert e.compat == compat_key(deps["a"])
    assert e.meta["t_intg_ms"] == deps["a"].t_intg_ms


def test_compat_key_equals_the_reference(jdeps, deps, other_geometry):
    """The same string as the reference's for the same config; the leak
    variant is left out, the geometry is not; canonical JSON."""
    for name in CIRCUITS:
        assert compat_key(deps[name]) == j_registry.compat_key(jdeps[name])
    assert len({compat_key(d) for d in deps.values()}) == 1
    assert compat_key(other_geometry) != compat_key(deps["a"])
    key = compat_key(deps["a"])
    d = json.loads(key)
    assert "leak" not in d["p2m"] and "v_threshold" not in d["p2m"]
    assert key == json.dumps(d, sort_keys=True, separators=(",", ":"))
    assert compat_digest(key) == j_registry.compat_digest(key)
    assert len(compat_digest(key)) == 12


@pytest.mark.parametrize("request_, kw, want", [
    ("b", {}, "b"),
    (None, {"default": "b"}, "b"),
    ({"circuit": "c"}, {}, "c"),
])
def test_resolve(deps, request_, kw, want):
    reg = _registry(deps, ("a", "b", "c"))
    assert reg.resolve(request_, **kw).name == want


def test_resolve_sole_entry(deps):
    assert _registry(deps, ("a",)).resolve(None).name == "a"


@pytest.mark.parametrize("request_, err, match", [
    ({"protocol": "frozen"}, ValueError, "ambiguous"),
    ({"circuit": "zz"}, LookupError, "no registry entry"),
    ("nope", LookupError, "no registry entry"),
    (None, ValueError, "ambiguous"),
    (3.14, TypeError, "variant request"),
])
def test_resolve_rejects(deps, request_, err, match):
    with pytest.raises(err, match=match):
        _registry(deps).resolve(request_)


def test_resolve_compat_filter(deps, other_geometry):
    reg = _registry(deps)
    reg.register("weird", other_geometry)
    anchor = compat_key(deps["a"])
    with pytest.raises(ValueError, match="incompatible"):
        reg.resolve("weird", compat=anchor)
    assert all(e.name != "weird"
               for e in reg.match({"protocol": "frozen"}, compat=anchor))


# ---------------------------------------------------------------------------
# engine construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make, match", [
    (lambda deps: StreamEngine(Registry(), capacity=2, device="cpu"),
     "empty"),
    (lambda deps: StreamEngine(_registry(deps), capacity=2, max_entries=1,
                               device="cpu"), "max_entries"),
    (lambda deps: StreamEngine(deps["a"], capacity=2, max_entries=4,
                               device="cpu"), "registry"),
])
def test_engine_construction_errors(deps, make, match):
    with pytest.raises(ValueError, match=match):
        make(deps)


def test_variants_require_registry(deps):
    eng = StreamEngine(deps["a"], capacity=2, device="cpu")
    with pytest.raises(ValueError, match="registry"):
        eng.serve(replay_factory(2, HW, 1000.0, SLOT_US, N_CLASSES)(), 2,
                  variants=["a", "a"])


def test_lane_executor_is_the_identity_at_one_device(deps):
    """devices=1 is the identity path: no padding, one shard, the same
    logits as an engine built without an executor; more cards than are
    visible raise before any stream opens."""
    ex = make_lane_executor(None)
    assert ex == LaneExecutor() == make_lane_executor(1)
    assert ex.devices == 1 and not ex.is_sharded
    assert ex.padded_size(5) == 5 and ex.axis == "lane"
    with pytest.raises(ValueError, match="visible"):
        make_lane_executor(torch.cuda.device_count() + 2, device="cuda")
    with pytest.raises(ValueError, match=">= 1"):
        LaneExecutor(devices=0)
    make = replay_factory(3, HW, 1000.0, SLOT_US, N_CLASSES)
    plain = StreamEngine(deps["a"], capacity=2, device="cpu").serve(make(), 3)
    with_ex = StreamEngine(deps["a"], capacity=2, executor=ex,
                           device="cpu").serve(make(), 3)
    for sid, r in by_stream(plain).items():
        np.testing.assert_array_equal(r.logits,
                                      by_stream(with_ex)[sid].logits)
    sh = with_ex.to_artifact()["sharding"]
    assert sh == {"devices": 1, "bin_workers": 1, "padded_capacity": 2,
                  "lanes_per_shard": 2, "per_shard_admitted": [3]}


# ---------------------------------------------------------------------------
# mixed-variant serving: against the reference, and against the port's
# single-variant serves
# ---------------------------------------------------------------------------

VARIANTS = ["a", "b", "c", "nope", "a", {"circuit": "b"}, "c", "a"]
N = len(VARIANTS)


@pytest.fixture(scope="module")
def make_src():
    return replay_factory(N, HW, 1000.0, SLOT_US, N_CLASSES)


@pytest.fixture(scope="module")
def mixed(deps, make_src):
    eng = StreamEngine(_registry(deps, ("a", "b", "c")), capacity=3,
                       device="cpu")
    return eng.serve(make_src(), N, variants=list(VARIANTS))


def test_mixed_serve_matches_the_reference(jdeps, mixed, make_src):
    """Logits within 1e-4 of the JAX package's mixed serve of the same
    records; predictions, bindings, rejections and the ledger equal."""
    reg = j_registry.Registry()
    for name in ("a", "b", "c"):
        reg.register(name, jdeps[name])
    jrep = JaxEngine(reg, capacity=3).serve(make_src(), N,
                                            variants=list(VARIANTS))
    got, want = by_stream(mixed), by_stream(jrep)
    assert sorted(got) == sorted(want) == [0, 1, 2, 4, 5, 6, 7]
    for sid, r in want.items():
        g = got[sid]
        assert (g.entry, g.entry_uid, g.label, g.prediction, g.n_events,
                g.admitted_window, g.finished_window) == \
            (r.entry, r.entry_uid, r.label, r.prediction, r.n_events,
             r.admitted_window, r.finished_window), sid
    assert_logits_close([got[s].logits for s in sorted(want)],
                        [want[s].logits for s in sorted(want)])
    jart, tart = jrep.to_artifact(), mixed.to_artifact()
    assert tart["admission"] == jart["admission"]
    assert tart["admission"]["n_rejected"] == 1
    assert tart["registry"]["compat"] == jart["registry"]["compat"]
    assert tart["registry"]["max_entries"] == jart["registry"]["max_entries"]
    keys = ("name", "uid", "n_admitted", "n_finished", "n_correct",
            "n_misses", "n_events", "n_readouts")
    assert ([{k: r[k] for k in keys} for r in tart["registry"]["entries"]]
            == [{k: r[k] for k in keys} for r in jart["registry"]["entries"]])


def test_mixed_serve_bit_identical_to_singles(deps, mixed, make_src):
    """Per stream, the mixed serve reproduces the single-variant serve of
    its entry bit for bit."""
    served = sorted(r.stream_id for r in mixed.results)
    for name in ("a", "b", "c"):
        # records replay in admission order: the single serve's stream j
        # replays what the mixed serve's j-th admitted stream did
        rep = StreamEngine(deps[name], capacity=3, device="cpu").serve(
            make_src(), len(served))
        single = {served[r.stream_id]: r for r in rep.results}
        for r in mixed.results:
            if r.entry == name:
                np.testing.assert_array_equal(r.logits,
                                              single[r.stream_id].logits)
                assert r.prediction == single[r.stream_id].prediction


def test_entry_table_pressure_matches_the_reference(jdeps, deps, make_src):
    """Three lanes, two table slots, a third variant registered and one
    retired mid-serve: the eviction order (stale slots first, then live
    unused ones) and the EntryTableFull and retired-name rejections are the
    reference's, stream for stream."""
    variants = ["a", "b", "c", "c", "a", "b", "b", "c"]
    runs = {}
    for pkg, make_reg, engine, kw in (
            ("jax", j_registry.Registry, JaxEngine, {}),
            ("torch", Registry, StreamEngine, {"device": "cpu"})):
        reg = make_reg()
        src_deps = jdeps if pkg == "jax" else deps
        for name in ("a", "b"):
            reg.register(name, src_deps[name])

        def hook(window, reg=reg, src_deps=src_deps):
            if window == 0 and "c" not in reg:
                reg.register("c", src_deps["c"])
            if window == 50 and "b" in reg:
                reg.retire("b")

        runs[pkg] = engine(reg, capacity=3, max_entries=2, **kw).serve(
            make_src(), N, variants=list(variants), on_window=hook)
    trep, jrep = runs["torch"], runs["jax"]
    assert trep.n_rejected == jrep.n_rejected == 4
    assert ({s: (r.entry, r.entry_uid, r.admitted_window)
             for s, r in by_stream(trep).items()}
            == {s: (r.entry, r.entry_uid, r.admitted_window)
                for s, r in by_stream(jrep).items()})
    assert trep.to_artifact()["admission"] == jrep.to_artifact()["admission"]
    assert_logits_close([r.logits for r in trep.results],
                        [r.logits for r in jrep.results])


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------

def test_hot_swap_keeps_other_lanes_bit_identical(deps, make_src):
    """Retire + register mid-serve: the lane bound to the old uid finishes
    on its weights, the post-swap request resolves to the new entry, and
    lanes bound to 'a' are bit-identical to a single-variant serve."""
    reg = _registry(deps)
    eng = StreamEngine(reg, capacity=2, max_entries=3, default_entry="a",
                       device="cpu")
    swapped = []

    def swap(window):
        if window == 2 and "b" in reg:
            old = reg.retire("b")
            new = reg.register("b2", deps["c"])
            swapped.append((old.uid, new.uid))

    rep = eng.serve(make_src(), 4, variants=["a", "b", "b2", None],
                    on_window=swap)
    assert swapped and swapped[0][0] != swapped[0][1]
    got = by_stream(rep)
    assert len(got) == 4
    assert got[1].entry == "b"          # admitted pre-swap, kept weights
    assert got[2].entry == "b2"         # post-swap request resolves
    assert got[0].entry == got[3].entry == "a"
    single = by_stream(StreamEngine(deps["a"], capacity=2,
                                    device="cpu").serve(make_src(), 4))
    for sid in (0, 3):
        np.testing.assert_array_equal(got[sid].logits, single[sid].logits)
    rows = {e["name"]: e for e in rep.to_artifact()["registry"]["entries"]}
    assert rows["b"]["n_finished"] == rows["b2"]["n_finished"] == 1


def test_entry_table_full_rejects(deps, make_src):
    """Every slot pinned by resident lanes: a request for a freshly
    registered entry is rejected (EntryTableFull), and serving goes on."""
    reg = _registry(deps, ("a",))
    eng = StreamEngine(reg, capacity=3, max_entries=1, device="cpu")
    rejected = []

    def swap(window):
        if window == 0 and "c" not in reg:
            reg.register("c", deps["c"])

    rep = eng.serve(make_src(), 3, variants=["a", "a", "c"], on_window=swap,
                    log=rejected.append)
    assert rep.n_rejected == 1
    assert any(EntryTableFull.__name__ in m or "entry slots" in m
               for m in rejected)
    assert {r.entry for r in rep.results} == {"a"} and len(rep.results) == 2


def test_slot_reclaimed_after_release(deps, make_src):
    """Once the last lane bound to a retired entry releases, its slot takes
    the next registration (serve 'a', swap, serve 'b' on one engine)."""
    reg = _registry(deps, ("a",))
    eng = StreamEngine(reg, capacity=2, max_entries=1, device="cpu")
    r1 = eng.serve(make_src(), 2)
    assert all(r.entry == "a" for r in r1.results)
    reg.retire("a")
    reg.register("b", deps["b"])
    r2 = eng.serve(make_src(), 2, variants=["b", "b"])
    assert all(r.entry == "b" for r in r2.results) and r2.n_rejected == 0
