"""Deployment registry: the catalog of servable checkpoints behind
multi-variant serving (``repro.stream.registry`` in PyTorch).

A fleet of P²M sensors never runs one checkpoint: each sensor wants the
circuit variant that matches its process corner. :class:`Registry` holds
named :class:`RegistryEntry` rows, each a :class:`~repro_torch.stream.
deploy.Deployment` with self-describing metadata (variant dict, dataset,
protocol, ``sensor_hw``, accuracy) and a **compat key**: the canonical
fingerprint of everything two entries must share to be served by one
engine (replay geometry, backbone, analog frontend), leaving out the leak
variant, which is what entries differ in.

Streams are offered with a variant request (an entry name, a metadata
matcher dict, or ``None`` for the engine default) that admission resolves
against the live registry (:meth:`Registry.resolve`); no match or an
ambiguous match rejects the stream. :meth:`Registry.register` and
:meth:`Registry.retire` may run while a serve is running (hot-swap): each
registration gets a fresh ``uid``, so a lane bound to a retired entry
finishes on the weights it was admitted with.

The compat key is the same string the reference computes for the same
config, so the two packages agree on which deployments co-serve.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Mapping

import torch

from repro_torch.stream.deploy import (Deployment, load_deployment,
                                       model_config_to_dict)


def compat_key(dep: Deployment) -> str:
    """Canonical fingerprint of the serving geometry ``dep`` requires: the
    model config without the leak block (the variant axis) and without the
    model-default ``v_threshold`` (each record pins its own), serialized
    with sorted keys."""
    d = model_config_to_dict(dep.model_cfg)
    d["p2m"].pop("leak", None)
    d["p2m"].pop("v_threshold", None)
    return json.dumps(d, sort_keys=True, separators=(",", ":"),
                      default=float)


def compat_digest(key: str) -> str:
    """Short stable digest of a compat key (display / artifact field)."""
    return hashlib.sha256(key.encode()).hexdigest()[:12]


@dataclass(frozen=True)
class RegistryEntry:
    """One deployed checkpoint in the catalog. ``uid`` is unique per
    registration, not per name: re-registering a retired name gives a new
    uid, which is how the engine tells weights apart across a hot-swap."""
    name: str
    dep: Deployment
    meta: dict
    compat: str
    uid: int

    @property
    def compat_digest(self) -> str:
        return compat_digest(self.compat)

    def describe(self) -> dict:
        """JSON-safe row for artifacts and CLI summaries."""
        return {"name": self.name, "uid": self.uid,
                "compat": self.compat_digest, **self.meta}


def entry_meta(dep: Deployment) -> dict:
    """Flat self-describing metadata of a deployment, so matcher dicts can
    address any field (``{"circuit": "c"}``, ``{"protocol": "frozen"}``).
    The variant dict is splatted and also kept whole under ``"variant"``."""
    variant = dict(dep.record.get("variant") or {})
    meta = {
        "label": dep.record.get("label"),
        "protocol": dep.protocol,
        "t_intg_ms": dep.t_intg_ms,
        "n_sub": dep.model_cfg.p2m.n_sub,
        "accuracy": dep.record.get("accuracy"),
        "dataset": dep.meta.get("dataset"),
        "sensor_hw": dep.meta.get("sensor_hw"),
        "variant": variant,
    }
    meta.update(variant)
    return meta


class Registry:
    """Mutable catalog of named deployments, resolved at admission. Every
    mutation bumps ``version``."""

    def __init__(self) -> None:
        self._entries: dict[str, RegistryEntry] = {}
        self._next_uid = 0
        self.version = 0

    # -- CRUD -----------------------------------------------------------
    def register(self, name: str, dep: Deployment, *,
                 meta: Mapping | None = None) -> RegistryEntry:
        """Add ``dep`` under ``name``. A live name cannot be registered
        again (``retire`` first: retire + register is the hot-swap).
        ``meta`` overrides or extends the self-described metadata."""
        if not name:
            raise ValueError("registry entry name must be non-empty")
        if name in self._entries:
            raise ValueError(
                f"registry entry {name!r} already exists (uid "
                f"{self._entries[name].uid}) — retire it first to hot-swap")
        m = entry_meta(dep)
        if meta:
            m.update(meta)
        entry = RegistryEntry(name=name, dep=dep, meta=m,
                              compat=compat_key(dep), uid=self._next_uid)
        self._next_uid += 1
        self._entries[name] = entry
        self.version += 1
        return entry

    def register_checkpoint(self, name: str, directory: str | Path, *,
                            artifact=None, meta: Mapping | None = None,
                            device: str | torch.device | None = None
                            ) -> RegistryEntry:
        """``load_deployment`` onto ``device`` + ``register`` in one step."""
        return self.register(
            name, load_deployment(directory, device=device,
                                  artifact=artifact), meta=meta)

    def retire(self, name: str) -> RegistryEntry:
        """Remove ``name``: it stops matching new admissions, while lanes
        already bound to it finish on its weights."""
        if name not in self._entries:
            raise KeyError(f"registry has no entry {name!r} "
                           f"(entries: {sorted(self._entries)})")
        entry = self._entries.pop(name)
        self.version += 1
        return entry

    # -- lookup ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> RegistryEntry:
        if name not in self._entries:
            raise KeyError(f"registry has no entry {name!r} "
                           f"(entries: {sorted(self._entries)})")
        return self._entries[name]

    def names(self) -> list[str]:
        """Entry names in registration order."""
        return list(self._entries)

    def entries(self) -> Iterator[RegistryEntry]:
        yield from self._entries.values()

    def match(self, matcher: Mapping, *,
              compat: str | None = None) -> list[RegistryEntry]:
        """Entries (registration order) whose metadata equals every
        ``matcher`` item, optionally only those with compat key
        ``compat``."""
        out = []
        for e in self._entries.values():
            if compat is not None and e.compat != compat:
                continue
            if all(e.meta.get(k) == v for k, v in matcher.items()):
                out.append(e)
        return out

    def resolve(self, request: "str | Mapping | None" = None, *,
                compat: str | None = None,
                default: str | None = None) -> RegistryEntry:
        """Admission-time variant selection: an entry name (exact), a
        matcher dict (must match exactly one entry), or ``None`` (the
        ``default`` name, else the sole entry). Raises ``LookupError`` when
        nothing matches, ``ValueError`` when the request is ambiguous or
        the entry's compat key is not ``compat``, ``TypeError`` for any
        other request."""
        if request is None:
            if default is not None:
                return self.resolve(default, compat=compat)
            if len(self._entries) == 1:
                return self.resolve(next(iter(self._entries)), compat=compat)
            raise ValueError(
                f"no variant requested and no default entry set, with "
                f"{len(self._entries)} entries registered — the request "
                f"is ambiguous")
        if isinstance(request, str):
            if request not in self._entries:
                raise LookupError(
                    f"no registry entry named {request!r} "
                    f"(entries: {sorted(self._entries)})")
            entry = self._entries[request]
            if compat is not None and entry.compat != compat:
                raise ValueError(
                    f"entry {request!r} is incompatible with the serving "
                    f"engine (compat {entry.compat_digest} != engine "
                    f"{compat_digest(compat)}) — its replay geometry or "
                    f"architecture differs")
            return entry
        if isinstance(request, Mapping):
            hits = self.match(request, compat=compat)
            if not hits:
                raise LookupError(
                    f"no registry entry matches {dict(request)!r} "
                    f"(entries: {sorted(self._entries)})")
            if len(hits) > 1:
                raise ValueError(
                    f"variant request {dict(request)!r} is ambiguous: "
                    f"matches {[e.name for e in hits]}")
            return hits[0]
        raise TypeError(f"variant request must be a name, a matcher "
                        f"mapping, or None — got {type(request).__name__}")
