"""Deployment handshake: sweep artifact + checkpoint → a servable model
(``repro.stream.deploy`` in PyTorch).

The ``p2m-codesign-sweep/v3`` artifact is the menu: :func:`select_record`
picks the record to deploy. The checkpoint is the weights:
:func:`deploy_from_sweep` slices the chosen variant out of a
``keep_params=True`` grid run and writes one checkpoint whose ``extra``
block embeds the record and the full model config, so
:func:`load_deployment` rebuilds the :class:`Deployment` from it alone.
Checkpoints are the reference's format (``checkpoint/store``), so either
package loads what the other wrote. :func:`offline_forward` is the
batched reference forward the online engine is held to. The adaptation
delta checkpoints (:func:`save_adapt_delta` and its loaders) carry one
adapted serving lane's learned deltas back into a servable deployment.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import codesign, leakage, p2m_layer, snn, variant_grid
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.codesign import P2MModelConfig
from repro_torch.core.leakage import CircuitConfig, LeakageConfig
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import LIFConfig, SpikingCNNConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.utils import tree_map

DEPLOY_SCHEMA = "p2m-stream-deploy/v1"


def model_config_to_dict(cfg: P2MModelConfig) -> dict:
    """JSON-safe dict of the full model config (enums → values); the same
    dict the reference writes."""
    d = asdict(cfg)
    d["p2m"]["leak"]["circuit"] = cfg.p2m.leak.circuit.value
    return d


def model_config_from_dict(d: dict) -> P2MModelConfig:
    """Inverse of :func:`model_config_to_dict` (lists → tuples)."""
    p2m = dict(d["p2m"])
    leak = dict(p2m.pop("leak"))
    leak["circuit"] = CircuitConfig(leak["circuit"])
    analog_cfg = AnalogConfig(**p2m.pop("analog"))
    bb = dict(d["backbone"])
    lif = LIFConfig(**bb.pop("lif"))
    bb["channels"] = tuple(bb["channels"])
    bb["input_hw"] = tuple(bb["input_hw"])
    return P2MModelConfig(
        p2m=P2MConfig(**p2m, analog=analog_cfg, leak=LeakageConfig(**leak)),
        backbone=SpikingCNNConfig(**bb, lif=lif),
        coarse_window_ms=d["coarse_window_ms"])


def leak_config_from_variant(variant: dict, base: LeakageConfig
                             ) -> LeakageConfig:
    """A record's ``"variant"`` dict → the LeakageConfig the serving path
    runs; the record's resolved comparator threshold is pinned as the
    variant's override."""
    return replace(base,
                   circuit=CircuitConfig(variant["circuit"]),
                   null_mismatch=float(variant["null_mismatch"]),
                   v_threshold=float(variant["v_threshold"]),
                   sigma=float(variant.get("sigma") or 0.0))


@dataclass
class Deployment:
    """One servable variant: model config, params + BN state (tensors on
    one device), the record it came from, and registry metadata."""
    model_cfg: P2MModelConfig
    params: dict                 # {"p2m": {...}, "backbone": {...}}
    bn_state: dict
    record: dict
    protocol: str = "frozen"
    meta: dict = field(default_factory=dict)

    @property
    def coeffs(self) -> leakage.LeakCoeffs:
        return leakage.leak_coeffs(self.model_cfg.p2m.leak,
                                   self.model_cfg.p2m.v_threshold)

    @property
    def t_intg_ms(self) -> float:
        return self.model_cfg.p2m.t_intg_ms

    @property
    def device(self) -> torch.device:
        return self.params["p2m"]["w"].device

    def deployed_meta(self) -> dict:
        """The ``"deployed"`` block of the serving-stats artifact."""
        return {"label": self.record.get("label"),
                "protocol": self.protocol,
                "t_intg_ms": self.t_intg_ms,
                "n_sub": self.model_cfg.p2m.n_sub,
                "variant": self.record.get("variant"),
                "accuracy_offline": self.record.get("accuracy")}


def tree_to(tree: Any, device: torch.device) -> Any:
    """A dict tree of tensors, arrays or floats → float32 tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    t = (tree if isinstance(tree, torch.Tensor)
         else torch.from_numpy(np.array(tree, np.float32)))
    return t.to(device=device, dtype=torch.float32)


def params_from_jax(tree: dict, device: str | torch.device | None = None
                    ) -> tuple[dict, dict]:
    """The reference's ``{"params": ..., "bn_state": ...}`` tree (numpy or
    array-like leaves, as ``jax.device_get`` or a checkpoint returns them)
    → the port's (params, bn_state) as float32 tensors on ``device``. The
    names and layouts (HWIO conv weights, [in, out] dense weights) are the
    reference's, so only the container changes."""
    dev = resolve_device(device)
    return tree_to(tree["params"], dev), tree_to(tree["bn_state"], dev)


def opt_state_from_jax(tree: dict, device: str | torch.device | None = None
                       ) -> dict:
    """The reference optimizer's state (``adamw``: ``{"mu", "nu",
    "step"}``, ``sgd``: ``{"mom", "step"}``; numpy or array-like leaves)
    → the port's on ``device``: float32 moment trees and an int32 0-dim
    ``step``, so a run can resume mid-way on either side."""
    dev = resolve_device(device)
    return {k: (torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                             device=dev) if k == "step" else tree_to(v, dev))
            for k, v in tree.items()}


def offline_forward(dep: Deployment, events: torch.Tensor) -> dict:
    """The deployment's offline batched forward on ``dep.device``.

    ``events``: [B, T, n_sub, H, W, 2] binned frames over the full stream.
    Returns layer-1 ``spikes`` and ``v_pre`` [B, T, H', W', C], the
    2x-``pooled`` maps, the backbone-grid ``coarse`` counts and the
    rate-decoded ``logits`` [B, n_classes].
    """
    cfg = dep.model_cfg
    events = torch.as_tensor(events, dtype=torch.float32, device=dep.device)
    with torch.no_grad():
        spikes, v_pre = p2m_layer.p2m_forward_curvefit_coeffs(
            dep.params["p2m"], events, cfg.p2m, dep.coeffs)
        B, T = spikes.shape[:2]
        tb = snn.max_pool(spikes.reshape((B * T,) + spikes.shape[2:]))
        pooled = tb.reshape((B, T) + tb.shape[1:])
        coarse = p2m_layer.coarsen_spikes(pooled, cfg.coarsen_group())
        logits, _, _ = snn.spiking_cnn_apply(
            dep.params["backbone"], dep.bn_state, coarse, cfg.backbone,
            train=False)
    return {"spikes": spikes, "v_pre": v_pre, "pooled": pooled,
            "coarse": coarse, "logits": logits}


def fresh_deployment(model_cfg: P2MModelConfig, *, seed: int = 0,
                     protocol: str = "frozen",
                     device: str | torch.device | None = None) -> Deployment:
    """An untrained deployment: weights from :func:`codesign.model_init`
    under ``torch.Generator().manual_seed(seed)`` (drawn on the CPU, so a
    seed gives the same weights on every device), placed on ``device``."""
    dev = resolve_device(device)
    params, state = codesign.model_init(torch.Generator().manual_seed(seed),
                                        model_cfg)
    lc = model_cfg.p2m.leak
    record = {
        "label": variant_grid.variant_label(lc),
        "t_intg_ms": model_cfg.p2m.t_intg_ms,
        "n_sub": model_cfg.p2m.n_sub,
        "variant": variant_grid.variant_dict(
            lc, v_threshold_default=model_cfg.p2m.v_threshold,
            n_sub=model_cfg.p2m.n_sub),
        "accuracy": None,
        "untrained": True,
    }
    return Deployment(model_cfg=model_cfg, params=tree_to(params, dev),
                      bn_state=tree_to(state, dev), record=record,
                      protocol=protocol)


def save_deployment(directory: str | Path, dep: Deployment) -> Path:
    """Write one committed, self-describing serving checkpoint."""
    tree = {"params": dep.params, "bn_state": dep.bn_state}
    extra = {
        "deploy_schema": DEPLOY_SCHEMA,
        "protocol": dep.protocol,
        "record": dep.record,
        "model_config": model_config_to_dict(dep.model_cfg),
        "registry_meta": dict(dep.meta),
    }
    return store.save_checkpoint(directory, 0, tree, extra)


def load_deployment(directory: str | Path,
                    device: str | torch.device | None = None, *,
                    artifact: dict | str | Path | None = None) -> Deployment:
    """Rebuild a :class:`Deployment` from a serving checkpoint (written by
    either package) onto ``device``. Corrupt or inconsistent extras raise
    ``ValueError`` instead of serving weights under the wrong numerics.
    ``artifact`` cross-checks the checkpoint against the sweep artifact it
    was deployed from: its record (label, protocol, T_INTG, n_sub) must be
    there."""
    dev = resolve_device(device)
    tree, extra = store.load_checkpoint(directory)
    if extra.get("deploy_schema") != DEPLOY_SCHEMA:
        raise ValueError(
            f"{directory} is not a streaming deployment checkpoint "
            f"(extra.deploy_schema={extra.get('deploy_schema')!r}; "
            f"expected {DEPLOY_SCHEMA!r})")
    missing = [k for k in ("record", "model_config", "protocol")
               if k not in extra]
    if missing:
        raise ValueError(f"{directory} deployment checkpoint extras are "
                         f"corrupt: missing {missing}")
    try:
        model_cfg = model_config_from_dict(extra["model_config"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"{directory} deployment checkpoint embeds a "
                         f"malformed model_config ({e!r})") from e
    record = extra["record"]
    for fld in ("t_intg_ms", "n_sub"):
        if fld in record and record[fld] != getattr(model_cfg.p2m, fld):
            raise ValueError(
                f"{directory} checkpoint record/model_config mismatch: "
                f"record.{fld}={record[fld]!r} but model_config pins "
                f"{getattr(model_cfg.p2m, fld)!r}")
    variant = record.get("variant") or {}
    if ("circuit" in variant
            and variant["circuit"] != model_cfg.p2m.leak.circuit.value):
        raise ValueError(
            f"{directory} checkpoint record/model_config mismatch: "
            f"record.variant.circuit={variant['circuit']!r} but "
            f"model_config pins {model_cfg.p2m.leak.circuit.value!r}")
    params, bn_state = params_from_jax(tree, dev)
    dep = Deployment(model_cfg=model_cfg, params=params, bn_state=bn_state,
                     record=record, protocol=extra["protocol"],
                     meta=dict(extra.get("registry_meta") or {}))
    if artifact is not None:
        _check_against_artifact(dep, artifact)
    return dep


def _check_against_artifact(dep: Deployment,
                            artifact: dict | str | Path) -> None:
    if isinstance(artifact, (str, Path)):
        artifact = json.loads(Path(artifact).read_text())
    key = ("label", "protocol", "t_intg_ms", "n_sub")
    want = tuple(dep.record.get(k) for k in key)
    for r in artifact.get("records", []):
        if tuple(r.get(k) for k in key) == want:
            return
    raise ValueError(
        f"checkpoint record {dict(zip(key, want))} not found in the sweep "
        f"artifact — the artifact and checkpoint are from different runs")


# ---------------------------------------------------------------------------
# record selection and deploying from a sweep
# ---------------------------------------------------------------------------

def _record_sort_key(r: dict) -> tuple:
    """Total order over sweep records: best accuracy first, then shortest
    T_INTG, label, protocol, n_sub and the key-sorted variant dict. Every
    component is a field of the record, never its position, so the same
    artifact deploys the same record however its JSON was written."""
    variant = r.get("variant") or {}
    return (-(r.get("accuracy") or 0.0), r["t_intg_ms"],
            str(r.get("label")), str(r.get("protocol")),
            r.get("n_sub") or 0,
            json.dumps(variant, sort_keys=True, default=float))


def select_record(records: list[dict], *, protocol: str | None = None,
                  t_intg_ms: float | None = None,
                  label: str | None = None) -> dict:
    """The record to deploy: filter by protocol / T_INTG / variant label,
    then the first in :func:`_record_sort_key`'s order."""
    pool = [r for r in records
            if (protocol is None or r.get("protocol") == protocol)
            and (t_intg_ms is None or r["t_intg_ms"] == t_intg_ms)
            and (label is None or r["label"] == label)]
    if not pool:
        raise ValueError(
            f"no sweep record matches protocol={protocol!r} "
            f"t_intg_ms={t_intg_ms!r} label={label!r} "
            f"({len(records)} records total)")
    return min(pool, key=_record_sort_key)


def select_from_artifact(artifact: dict | str | Path, **kwargs) -> dict:
    """:func:`select_record` over a sweep-artifact dict or JSON path."""
    if isinstance(artifact, (str, Path)):
        artifact = json.loads(Path(artifact).read_text())
    schema = artifact.get("schema", "")
    if not str(schema).startswith("p2m-codesign-sweep/"):
        raise ValueError(f"not a co-design sweep artifact "
                         f"(schema={schema!r})")
    return select_record(artifact["records"], **kwargs)


def deploy_from_sweep(result: Any, model_cfg: P2MModelConfig, record: dict,
                      directory: str | Path,
                      meta: dict | None = None) -> Path:
    """Slice ``record``'s variant out of a ``keep_params=True``
    ``core.sweep.GridResult`` and write its serving checkpoint. Frozen
    cells share one layer 1; unfrozen cells carry a per-variant layer 1,
    sliced like the backbone. ``meta`` is kept as the checkpoint's
    registry metadata."""
    cell = (record["t_intg_ms"], record["n_sub"])
    if cell not in result.final_params:
        raise ValueError(
            f"grid result holds no final params for cell {cell} — run the "
            f"sweep with keep_params=True (cells kept: "
            f"{sorted(result.final_params)})")
    g = list(result.labels).index(record["label"])
    fp = result.final_params[cell]

    def take(tree):
        return tree_map(lambda v: v[g], tree)

    p2m_params = (take(fp["p2m"]) if result.protocol == "unfrozen"
                  else fp["p2m"])
    leak = leak_config_from_variant(record["variant"], model_cfg.p2m.leak)
    cfg_cell = replace(model_cfg, p2m=replace(
        model_cfg.p2m, t_intg_ms=record["t_intg_ms"],
        n_sub=record["n_sub"], mode="curvefit", leak=leak))
    dep = Deployment(model_cfg=cfg_cell,
                     params={"p2m": p2m_params,
                             "backbone": take(fp["backbone"])},
                     bn_state=take(fp["state"]),
                     record=record, protocol=result.protocol,
                     meta=dict(meta or {}))
    return save_deployment(directory, dep)


# ---------------------------------------------------------------------------
# adaptation delta checkpoints (stream/adapt.py → new registry entries)
# ---------------------------------------------------------------------------

ADAPT_DELTA_SCHEMA = "p2m-stream-adapt-delta/v1"


def host_effective_weights(dep: Deployment) -> np.ndarray:
    """``dep``'s quantized layer-1 weights as host float32, by the
    reference's order of operations in numpy (clip, divide by the level
    step, round half to even, scale, then the straight-through
    ``w + (q - w)``). The same bits on every device, so a delta harvested
    on the card validates and applies on the CPU, in either package."""
    a_cfg = dep.model_cfg.p2m.analog
    w = dep.params["p2m"]["w"]
    w = np.asarray(w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
                   else w, np.float32)
    lim = np.float32(a_cfg.w_clip)
    w = np.minimum(np.maximum(w, -lim), lim)
    scale = np.float32(a_cfg.w_clip / (a_cfg.weight_levels // 2))
    q = np.round(w / scale) * scale
    return w + (q - w)


def deployment_digest(dep: Deployment) -> str:
    """Content digest of a deployment as an adaptation base: the full model
    config, the exact quantized layer-1 weights and the comparator
    threshold that per-lane deltas are relative to. It equals the
    reference's digest of the same deployment."""
    h = hashlib.sha256()
    h.update(json.dumps(model_config_to_dict(dep.model_cfg),
                        sort_keys=True, default=float).encode())
    h.update(host_effective_weights(dep).tobytes())
    h.update(np.float32(dep.coeffs.v_threshold).tobytes())
    return h.hexdigest()[:16]


def save_adapt_delta(directory: str | Path, base: Deployment, *,
                     dw, dtheta: float, base_name: str = "default",
                     base_uid: int = 0, lane: int = 0, n_updates: int = 0,
                     rule: str = "surrogate",
                     meta: dict | None = None) -> Path:
    """Write one adapted lane's deltas as a committed delta checkpoint.

    ``dw``/``dtheta`` are relative to ``base``'s quantized layer-1 weights
    and deployed threshold (the lane served ``quantize(w_q_base + dw)`` at
    ``theta_base + dtheta``, as ``StreamEngine.harvest`` returns them). The
    extras stamp the base's registry identity and content digest, which
    :func:`load_adapt_delta` validates."""
    dw = np.asarray(dw.detach().cpu().numpy() if isinstance(dw, torch.Tensor)
                    else dw, np.float32)
    w_q = host_effective_weights(base)
    if dw.shape != w_q.shape:
        raise ValueError(
            f"dw shape {dw.shape} does not match the base's layer-1 "
            f"weights {tuple(w_q.shape)}")
    tree = {"dw": dw, "dtheta": np.float32(dtheta)}
    extra = {
        "delta_schema": ADAPT_DELTA_SCHEMA,
        "base": {"name": base_name, "uid": int(base_uid),
                 "digest": deployment_digest(base)},
        "lane": int(lane),
        "n_updates": int(n_updates),
        "rule": rule,
        "meta": dict(meta or {}),
    }
    return store.save_checkpoint(directory, 0, tree, extra)


def load_adapt_delta(directory: str | Path, base: Deployment, *,
                     expect_uid: int | None = None) -> dict:
    """Load a delta checkpoint (written by either package) and validate it
    against ``base``. Raises ``ValueError`` when it is not a delta, its
    base stamp is incomplete, the stamped digest is not ``base``'s, the
    stamped uid is not ``expect_uid`` (the base was hot-swapped since the
    harvest), or ``dw`` has the wrong shape."""
    tree, extra = store.load_checkpoint(directory)
    if extra.get("delta_schema") != ADAPT_DELTA_SCHEMA:
        raise ValueError(
            f"{directory} is not an adaptation delta checkpoint "
            f"(extra.delta_schema={extra.get('delta_schema')!r}; "
            f"expected {ADAPT_DELTA_SCHEMA!r})")
    stamped = extra.get("base") or {}
    missing = [k for k in ("name", "uid", "digest") if k not in stamped]
    if missing:
        raise ValueError(f"{directory} delta checkpoint base stamp is "
                         f"corrupt: missing {missing}")
    digest = deployment_digest(base)
    if stamped["digest"] != digest:
        raise ValueError(
            f"{directory} delta was learned against base digest "
            f"{stamped['digest']} but the offered deployment digests to "
            f"{digest} — applying it would adapt the wrong weights")
    if expect_uid is not None and int(stamped["uid"]) != int(expect_uid):
        raise ValueError(
            f"{directory} delta is stamped for base uid {stamped['uid']} "
            f"but the live registration is uid {expect_uid} — the base "
            f"entry was hot-swapped since this delta was harvested")
    dw = np.asarray(tree["dw"], np.float32)
    w_q = host_effective_weights(base)
    if dw.shape != w_q.shape:
        raise ValueError(
            f"{directory} delta dw shape {dw.shape} does not match the "
            f"base's layer-1 weights {tuple(w_q.shape)}")
    return {"dw": dw, "dtheta": float(tree["dtheta"]),
            "base_name": stamped["name"], "base_uid": int(stamped["uid"]),
            "lane": int(extra.get("lane", 0)),
            "n_updates": int(extra.get("n_updates", 0)),
            "rule": extra.get("rule"), "meta": dict(extra.get("meta") or {})}


def apply_adapt_delta(base: Deployment, delta: dict, *,
                      label_suffix: str = "+adapt") -> Deployment:
    """Fold a validated delta into ``base``: a new :class:`Deployment` on
    ``base.device`` with raw layer-1 weights ``w_q_base + dw`` (which
    quantize to what the adapted lane served) and comparator threshold
    ``theta_base + dtheta`` pinned as the leak-config override. Its compat
    key is its base's, so it registers beside it."""
    cfg = base.model_cfg
    w_q = host_effective_weights(base)
    new_theta = float(base.coeffs.v_threshold) + float(delta["dtheta"])
    model_cfg = replace(cfg, p2m=replace(
        cfg.p2m, leak=replace(cfg.p2m.leak, v_threshold=new_theta)))
    variant = dict(base.record.get("variant") or {})
    if "v_threshold" in variant:
        variant["v_threshold"] = new_theta
    record = {
        **base.record,
        "label": f"{base.record.get('label')}{label_suffix}",
        "variant": variant,
        "adapted": {"base_name": delta.get("base_name", "default"),
                    "base_uid": int(delta.get("base_uid", 0)),
                    "lane": int(delta.get("lane", 0)),
                    "n_updates": int(delta.get("n_updates", 0)),
                    "rule": delta.get("rule"),
                    "dw_norm": float(np.linalg.norm(delta["dw"]))},
    }
    w = w_q + np.asarray(delta["dw"], np.float32)
    params = {"p2m": {**base.params["p2m"],
                      "w": torch.from_numpy(w).to(base.device)},
              "backbone": base.params["backbone"]}
    return Deployment(model_cfg=model_cfg, params=params,
                      bn_state=base.bn_state, record=record,
                      protocol=base.protocol, meta=dict(base.meta))


def train_and_deploy(out_dir: str | Path, *,
                     dataset: str = "synthetic-gesture",
                     data_root: str | None = None, hw: int = 16,
                     protocols: tuple[str, ...] = ("frozen",),
                     t_intg_grid_ms: tuple[float, ...] | None = None,
                     circuits: tuple[CircuitConfig, ...] | None = None,
                     smoke: bool = False,
                     deploy_t_intg_ms: float | None = None,
                     log: Any = print,
                     device: str | torch.device | None = None) -> dict:
    """Run a fast-grid co-design sweep with ``keep_params=True`` on
    ``device``, write the sweep artifact, and deploy the best record per
    protocol as a serving checkpoint. Returns ``{"artifact": path,
    "checkpoints": {protocol: dir}, "records": {protocol: record},
    "results": {protocol: GridResult}, "source": train EventSource}``.
    ``smoke`` cuts the step counts to the reference's smoke scale;
    ``deploy_t_intg_ms`` pins the deployed record's integration time."""
    from repro_torch.core import sweep as engine
    from repro_torch.data import sources as sources_mod

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    data, model, sweep_cfg, grid = engine.paper_setup(
        fast=True, hw=hw, dataset=dataset, data_root=data_root)
    if smoke:
        sweep_cfg = replace(sweep_cfg, batch_size=2, pretrain_steps=2,
                            finetune_steps=1, eval_batches=1)
    if t_intg_grid_ms is not None:
        ok = set(engine.fit_t_grid(t_intg_grid_ms, data.duration_ms,
                                   model.coarse_window_ms))
        bad = [t for t in t_intg_grid_ms if t not in ok]
        if bad:
            raise ValueError(
                f"T_INTG values {bad} do not divide the coarse window "
                f"({model.coarse_window_ms:g} ms) and stream duration "
                f"({data.duration_ms:g} ms)")
        grid = replace(grid, t_intg_grid_ms=tuple(t_intg_grid_ms))
    if circuits is not None:
        grid = replace(grid, circuits=tuple(circuits))
    eval_data, eval_split = sources_mod.resolve_eval_dataset(
        dataset, hw=hw, data_root=data_root)
    results = engine.run_protocols(data, model, sweep_cfg, grid,
                                   protocols=protocols, log=log,
                                   eval_data=eval_data, keep_params=True,
                                   device=device)
    artifact = engine.protocols_artifact(results, extra_meta={
        "data": {"name": data.name, "dataset": dataset,
                 "data_root": data_root, "hw": data.height,
                 "n_classes": data.n_classes,
                 "duration_ms": data.duration_ms,
                 "eval_split": eval_split}})
    artifact_path = out / "codesign_grid_deploy.json"
    artifact_path.write_text(json.dumps(artifact, indent=2))
    checkpoints: dict[str, Path] = {}
    chosen: dict[str, dict] = {}
    for proto, result in results.items():
        rec = select_record(result.records, t_intg_ms=deploy_t_intg_ms)
        ckpt_dir = out / f"ckpt_{proto}"
        deploy_from_sweep(result, model, rec, ckpt_dir,
                          meta={"dataset": dataset,
                                "sensor_hw": list(data.sensor_hw)})
        checkpoints[proto] = ckpt_dir
        chosen[proto] = rec
        log(f"[deploy] {proto}: {rec['label']} @ T={rec['t_intg_ms']:g}ms "
            f"acc={rec['accuracy']:.3f} -> {ckpt_dir}")
    return {"artifact": artifact_path, "checkpoints": checkpoints,
            "records": chosen, "results": results, "source": data}
