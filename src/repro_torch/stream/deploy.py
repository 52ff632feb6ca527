"""Servable deployments: model config + params + the record they serve
(the serving half of ``repro.stream.deploy`` in PyTorch).

A deployment checkpoint is the reference's format (``checkpoint/store``
with a self-describing ``extra`` block), so a checkpoint the JAX package
wrote loads here unchanged. :func:`offline_forward` is the batched
reference forward the online engine is held to.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import codesign, leakage, p2m_layer, snn
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.codesign import P2MModelConfig
from repro_torch.core.leakage import CircuitConfig, LeakageConfig
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import LIFConfig, SpikingCNNConfig
from repro_torch.kernels.backend import resolve_device

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


def _variant_label(lc: LeakageConfig) -> str:
    """The reference's record label (circuit + one suffix per variant axis
    off its default: mismatch on circuit (c), threshold override, sigma)."""
    parts = [lc.circuit.value]
    if lc.circuit == CircuitConfig.NULLIFIED:
        parts.append(f"m={lc.null_mismatch:g}")
    if lc.v_threshold is not None:
        parts.append(f"vt={lc.v_threshold:g}")
    if lc.sigma:
        parts.append(f"s={lc.sigma:g}")
    return "@".join(parts)


def _variant_dict(lc: LeakageConfig, *, v_threshold_default: float,
                  n_sub: int) -> dict:
    """The reference's per-record ``"variant"`` dict."""
    return {"circuit": lc.circuit.value, "null_mismatch": lc.null_mismatch,
            "v_threshold": leakage.resolve_v_threshold(lc, v_threshold_default),
            "sigma": lc.sigma, "n_sub": n_sub}


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
        "label": _variant_label(lc),
        "t_intg_ms": model_cfg.p2m.t_intg_ms,
        "n_sub": model_cfg.p2m.n_sub,
        "variant": _variant_dict(lc,
                                 v_threshold_default=model_cfg.p2m.v_threshold,
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
                    device: str | torch.device | None = None) -> Deployment:
    """Rebuild a :class:`Deployment` from a serving checkpoint (written by
    either package) onto ``device``. Corrupt or inconsistent extras raise
    ``ValueError`` instead of serving weights under the wrong numerics."""
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
    return Deployment(model_cfg=model_cfg, params=params, bn_state=bn_state,
                      record=record, protocol=extra["protocol"],
                      meta=dict(extra.get("registry_meta") or {}))


def compat_digest(dep: Deployment) -> str:
    """Digest of the serving geometry (the reference registry's compat key:
    the model config minus the leak block and the default threshold)."""
    d = model_config_to_dict(dep.model_cfg)
    d["p2m"].pop("leak", None)
    d["p2m"].pop("v_threshold", None)
    key = json.dumps(d, sort_keys=True, separators=(",", ":"), default=float)
    return hashlib.sha256(key.encode()).hexdigest()[:12]
