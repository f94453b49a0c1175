"""`KernelPolicy` — the one home of kernel-selection state in the port.

Counterpart of ``repro.core.policy``, with the reference's names, labels,
op names, aliases, knob schema and validation, so that a policy string or
an autotune-table entry means the same in both packages:

* :class:`KernelPolicy` — a frozen, hashable dataclass: the global
  ``path``, per-op overrides (``op_paths``), a ``backend`` preference, the
  ``autotune`` mode and table, per-op tuning overrides (``op_tuning``) and
  what ``tile`` does where no kernel runs (``interpret_fallback``).
* :class:`TuneSpec` — one op's kernel geometry as data, validated against
  :data:`KNOB_SCHEMA`.
* :meth:`KernelPolicy.resolve` — the port's only resolution algorithm. It
  returns a :class:`ResolvedPath`: a ``str`` label that also carries the
  resolved :class:`TuneSpec`, which ``repro_torch.core.dispatch`` hands to
  the kernel wrappers.
* :func:`default_policy` — the process default, built from
  ``REPRO_KERNEL_PATH``, ``REPRO_AUTOTUNE`` and ``REPRO_AUTOTUNE_TABLE``.
  **This module is the only one that reads them** (a test greps for it).
* :func:`get_policy` / :func:`set_policy` / :func:`using_policy` — the
  active policy on a ``contextvars.ContextVar``: scoped and thread-safe.

The labels on the port:

  ``auto``      per shape, from the measured table of
                ``repro_torch.core.autotune`` (its section for the tensor's
                device), else its heuristic; the default
  ``tile``      the Hopper kernel: ``tile_gpu`` on a CUDA tensor of a
                compute-capability 9.0 card; on a CPU tensor
                ``interpret`` (one warning; ``interpret_fallback="error"``
                raises, ``backend="cpu"`` is silent)
  ``tile_gpu``  the kernel of ``csrc/``; raises off the card
  ``tile_tpu``  the reference's Pallas-TPU kernel; always raises here
  ``interpret`` the kernel's plain version (``kernels/ref.py``) on any
                device
  ``tile_logdepth``  the log-depth MatMulScan family (scan, weighted_scan,
                ssd): the local kernels of ``csrc/matmul_scan.cu`` and the
                tree of ``kernels/matmul_scan.py``; on a CPU tensor the
                local passes' plain versions (one warning)
  ``fused``     the matmul forms of ``repro_torch.core`` in torch
  ``xla_tile``  the paper's tile algebra (``formulation="tile"``) for the
                reduce; the fused forms for the other ops
  ``baseline``  torch's own op or the sequential oracle

**The backend is keyed on the call's tensor device, not the process**:
:meth:`KernelPolicy.resolve` takes ``device=``, and the same policy gives
``tile_gpu`` for a CUDA tensor and ``interpret`` for a CPU tensor in one
process. The reference asks ``jax.default_backend()`` instead. A CUDA
tensor on a card of another compute capability has no kernel to run:
``auto``, ``tile`` and ``tile_logdepth`` raise for it (only an explicit
``interpret``, ``fused``, ``xla_tile``, ``baseline`` or ``backend="cpu"``
runs there), so data on a card is never served by the plain versions
unasked.

The reference resolves once per jit trace; the port resolves on every eager
call, so resolution is memoised (string specs by ``(spec, base)``, results
by ``(policy, op, n, dtype, level, explicit, device)``).
:func:`invalidate_cache` clears it, as does a change of the env-var state
behind :func:`default_policy` or a table reload. Events and counters fire on
every call, outside the memo.

String shorthands (accepted everywhere a policy is): a bare label
(``"fused"``), per-op overrides (``"attention=fused,reduce=tile"``, a bare
label mixed in sets the global path), dotted tuning knobs
(``"tile,ssd.q=32"``), or a JSON object of fields
(``'{"path": "auto", "autotune": "off"}'``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import json
import os
import warnings
from typing import Any, Iterator, Mapping

from repro_torch.obs import runtime as _obs
from repro_torch.parallel import mesh_context as _mesh
# the active mesh context: its one ``get`` is all the shard hook costs a
# resolution outside any context
from repro_torch.parallel.mesh_context import _ACTIVE as _MESH_ACTIVE

# The env vars (parsed ONLY here; other modules may re-export the names):
ENV_PATH = "REPRO_KERNEL_PATH"         # default path label
ENV_AUTOTUNE = "REPRO_AUTOTUNE"        # "off"/"0"/"static"/"false" -> off
ENV_TABLE = "REPRO_AUTOTUNE_TABLE"     # explicit autotune table file

# Path labels by level, the reference's: "dispatch" admits the algorithm-
# level contenders (xla_tile, baseline); "kernel" is the subset a kernel
# wrapper understands.
DISPATCH_PATHS = ("auto", "fused", "xla_tile", "tile", "tile_tpu",
                  "tile_gpu", "tile_logdepth", "interpret", "baseline")
KERNEL_PATHS = ("auto", "fused", "tile", "tile_tpu", "tile_gpu",
                "tile_logdepth", "interpret")
_DISPATCH_ONLY = ("xla_tile", "baseline")

BACKENDS = ("cpu", "gpu", "tpu")
AUTOTUNE_MODES = ("on", "off")
INTERPRET_FALLBACKS = ("warn", "silent", "error")

# Canonical op names a policy can carry overrides for; the kernel-level
# spellings alias onto them so one override steers both levels.
KNOWN_OPS = ("reduce", "scan", "weighted_scan", "ragged_reduce",
             "ragged_scan", "rmsnorm", "attention", "ssd")
OP_ALIASES = {"segmented_reduce": "reduce", "segmented_scan": "scan",
              "ssd_scan": "ssd"}
# the ops with a log-depth MatMulScan kernel
LOGDEPTH_OPS = ("scan", "weighted_scan", "ssd")

# Per-op tuning-knob schema, the reference's: the only knob names a
# TuneSpec (and an autotune-table entry's ``tuning``) may carry. The values
# live in ``repro_torch.kernels.layout``; a knob no Hopper kernel takes is
# legal (so that one spec serves both packages), warns once and is left
# out of the resolved spec (see ``KernelPolicy.tuning_for``).
KNOB_SCHEMA = {
    "reduce": ("block_s", "block_n", "num_warps", "num_stages"),
    "scan": ("block_s", "block_n", "radix", "fan_in",
             "num_warps", "num_stages"),
    "weighted_scan": ("q", "radix", "fan_in", "num_warps", "num_stages"),
    "ragged_reduce": (),
    "ragged_scan": (),
    "rmsnorm": ("row_block", "block_d", "num_warps", "num_stages"),
    "attention": ("block_q", "block_k", "num_warps", "num_stages"),
    "ssd": ("q", "radix", "fan_in", "num_warps", "num_stages"),
}


# ---------------------------------------------------------------------------
# one-time warnings


_WARNED: set[str] = set()


def warn_once(key: str, message: str, category: type = DeprecationWarning,
              stacklevel: int = 3) -> None:
    """Emit ``message`` the first time ``key`` is seen this process."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, category, stacklevel=stacklevel + 1)


def _warn_tile_downgrade(device) -> None:
    """One-time notice that ``tile`` ran a kernel's plain version: at real
    sizes that looks like a hang, so say so once per process."""
    warn_once(
        "downgrade:tile",
        f"path='tile' has no Hopper kernel for a tensor on {device} (the "
        "kernels need a CUDA card of compute capability 9.0); running the "
        "kernel's plain version instead. Pass path='interpret' explicitly "
        "to silence this one-time warning.", UserWarning, stacklevel=5)


def _warn_logdepth_downgrade(device) -> None:
    """One-time notice that ``tile_logdepth``'s local passes run their
    plain versions (the label is kept: the log-depth tree still runs)."""
    warn_once(
        "downgrade:tile_logdepth",
        f"path='tile_logdepth' has no Hopper kernel for a tensor on "
        f"{device}; the log-depth tree still runs but its local block "
        "passes run their plain versions. Set interpret_fallback='silent' "
        "to silence this one-time warning.", UserWarning, stacklevel=5)


# ---------------------------------------------------------------------------
# tuning specs


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """Per-op kernel tuning geometry, frozen and hashable.

    ``op`` is a canonical op name (aliases normalise); ``knobs`` a mapping
    or tuple of ``(knob, value)`` pairs, normalised to a sorted tuple, each
    key validated against :data:`KNOB_SCHEMA` and each value a positive
    int. Construction also takes a ``"q=64,radix=16"`` string through
    :meth:`from_spec`. :meth:`KernelPolicy.tuning_for` merges the layout
    defaults, the autotune table's swept winner and the policy's
    ``op_tuning`` into the spec a kernel runs with.
    """

    op: str
    knobs: tuple = ()

    def __post_init__(self):
        op = OP_ALIASES.get(str(self.op), str(self.op))
        object.__setattr__(self, "op", op)
        if op not in KNOWN_OPS:
            raise ValueError(
                f"TuneSpec: unknown op {op!r}; expected one of {KNOWN_OPS} "
                f"(or a kernel-registry alias {tuple(OP_ALIASES)})")
        pairs = self.knobs
        if isinstance(pairs, Mapping):
            pairs = pairs.items()
        allowed = KNOB_SCHEMA[op]
        norm = []
        for k, v in sorted((str(k), v) for k, v in pairs):
            if k not in allowed:
                raise ValueError(
                    f"TuneSpec({op!r}): unknown knob {k!r}; expected one "
                    f"of {allowed} — a typo here would silently no-op")
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                raise ValueError(
                    f"TuneSpec({op!r}): knob {k!r} must be a positive "
                    f"int, got {v!r}")
            norm.append((k, v))
        object.__setattr__(self, "knobs", tuple(norm))

    @classmethod
    def from_spec(cls, op: str, spec: "TuneSpec | Mapping | str"
                  ) -> "TuneSpec":
        """Coerce a tuning spec for ``op``: a :class:`TuneSpec`, a mapping
        of knob values, or a ``"knob=value,knob=value"`` string."""
        if isinstance(spec, TuneSpec):
            if OP_ALIASES.get(str(op), str(op)) != spec.op:
                raise ValueError(
                    f"TuneSpec for op {spec.op!r} used under op {op!r}")
            return spec
        if isinstance(spec, Mapping):
            return cls(op=op, knobs=spec)
        if not isinstance(spec, str):
            raise TypeError(
                f"cannot build a TuneSpec from {type(spec).__name__}: "
                f"{spec!r}")
        knobs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(
                    f"TuneSpec string must be 'knob=value,...', got "
                    f"{spec!r}")
            knobs[k.strip()] = int(v)
        return cls(op=op, knobs=knobs)

    def get(self, key: str, default=None):
        """The value of one knob, or ``default`` when the spec lacks it."""
        for k, v in self.knobs:
            if k == key:
                return v
        return default

    def as_dict(self) -> dict:
        return dict(self.knobs)

    def label(self) -> str:
        """Compact form for sweep keys (``"block_n=256;radix=16"``; ``"-"``
        for an empty spec)."""
        return ";".join(f"{k}={v}" for k, v in self.knobs) or "-"


class ResolvedPath(str):
    """What :meth:`KernelPolicy.resolve` returns: a plain ``str`` label that
    also carries the resolved :class:`TuneSpec` as ``.tuning`` (None when
    the call had no op)."""

    __slots__ = ("tuning",)

    def __new__(cls, label: str, tuning: "TuneSpec | None" = None):
        self = str.__new__(cls, label)
        self.tuning = tuning
        return self


# ---------------------------------------------------------------------------
# the policy object


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Full kernel-selection state, frozen and hashable (the reference's
    fields).

    ``path``
        Global path label (any of :data:`DISPATCH_PATHS`).
    ``op_paths``
        Per-op overrides that beat ``path`` (a mapping or ``(op, path)``
        pairs, normalised to a sorted tuple).
    ``backend``
        None (the tensor's device decides), ``"gpu"``/``"tpu"`` (``tile``
        forces that backend's kernel and raises where it has none), or
        ``"cpu"`` (``tile`` runs the plain version, silently).
    ``autotune``
        ``"on"`` (``auto`` per shape from the table or the heuristic) or
        ``"off"`` (static ``auto``: ``tile`` where a kernel runs, ``fused``
        elsewhere).
    ``autotune_table``
        An explicit table file; None: the checked-in default. A set table
        that cannot be used raises (``repro_torch.core.autotune``).
    ``op_tuning``
        Per-op :class:`TuneSpec` overrides, e.g. ``{"ssd": {"q": 32}}``,
        beating the layout defaults and the table's swept winner.
    ``interpret_fallback``
        What ``tile`` does where no kernel runs: ``"warn"`` (run the plain
        version, warn once), ``"silent"`` or ``"error"``.
    """

    path: str = "auto"
    op_paths: tuple = ()
    backend: str | None = None
    autotune: str = "on"
    autotune_table: str | None = None
    op_tuning: tuple = ()
    interpret_fallback: str = "warn"

    def __post_init__(self):
        pairs = self.op_paths
        if isinstance(pairs, Mapping):
            pairs = pairs.items()
        pairs = tuple(sorted(
            (OP_ALIASES.get(str(op), str(op)), str(p)) for op, p in pairs))
        object.__setattr__(self, "op_paths", pairs)
        tune = self.op_tuning
        if isinstance(tune, Mapping):
            tune = tune.items()
        # entries aliasing one op ("ssd" and "ssd_scan") merge; a conflicting
        # value for one knob is ambiguous and raises
        merged: dict[str, dict] = {}
        for op_name, spec in tune:
            canon = OP_ALIASES.get(str(op_name), str(op_name))
            ts = TuneSpec.from_spec(str(op_name), spec)
            cur = merged.setdefault(canon, {})
            for k, v in ts.knobs:
                if k in cur and cur[k] != v:
                    raise ValueError(
                        f"op_tuning: conflicting values for "
                        f"{canon}.{k} ({cur[k]} vs {v}) — the op was "
                        "specified twice under aliased names")
                cur[k] = v
        tune = tuple(sorted(
            ((op, TuneSpec(op, kn)) for op, kn in merged.items()),
            key=lambda kv: kv[0]))
        object.__setattr__(self, "op_tuning", tune)
        if self.path not in DISPATCH_PATHS:
            raise ValueError(
                f"unknown path {self.path!r}; expected one of "
                f"{DISPATCH_PATHS}")
        for op, p in pairs:
            if op not in KNOWN_OPS:
                raise ValueError(
                    f"op_paths: unknown op {op!r}; expected one of "
                    f"{KNOWN_OPS} (or a kernel-registry alias "
                    f"{tuple(OP_ALIASES)}) — a typo here would silently "
                    "no-op")
            if p not in DISPATCH_PATHS:
                raise ValueError(
                    f"op_paths[{op!r}]: unknown path {p!r}; expected one "
                    f"of {DISPATCH_PATHS}")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of "
                f"{BACKENDS} or None")
        if self.autotune not in AUTOTUNE_MODES:
            raise ValueError(
                f"unknown autotune mode {self.autotune!r}; expected one of "
                f"{AUTOTUNE_MODES}")
        if self.interpret_fallback not in INTERPRET_FALLBACKS:
            raise ValueError(
                f"unknown interpret_fallback {self.interpret_fallback!r}; "
                f"expected one of {INTERPRET_FALLBACKS}")
        # the memo keys hash the policy on every call: hash the fields once
        object.__setattr__(self, "_hash", hash(dataclasses.astuple(self)))

    def __hash__(self) -> int:
        return self._hash

    def __getstate__(self) -> dict:
        # the fields only: a string's hash differs between processes
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __setstate__(self, state: dict) -> None:
        for k, v in state.items():
            object.__setattr__(self, k, v)
        object.__setattr__(self, "_hash", hash(dataclasses.astuple(self)))

    # -- construction -------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: "KernelPolicy | Mapping | str",
                  base: "KernelPolicy | None" = None) -> "KernelPolicy":
        """Coerce a policy spec onto ``base`` (default: a fresh policy): a
        :class:`KernelPolicy` (returned as is), a mapping of field
        overrides, or a string — a bare label, an ``op=path,...`` list
        (dotted keys are tuning knobs: ``"tile,ssd.q=32"``), or JSON."""
        if isinstance(spec, KernelPolicy):
            return spec
        if base is None:
            base = cls()
        if isinstance(spec, Mapping):
            return dataclasses.replace(base, **dict(spec))
        if not isinstance(spec, str):
            raise TypeError(
                f"cannot build a KernelPolicy from {type(spec).__name__}: "
                f"{spec!r}")
        return _from_string(spec, base)

    # -- resolution ---------------------------------------------------------

    def for_op(self, op: str | None) -> str:
        """The label this policy requests for ``op`` (override > global)."""
        if op is not None:
            op = OP_ALIASES.get(op, op)
            for name, p in self.op_paths:
                if name == op:
                    return p
        return self.path

    def tuning_for(self, op: str | None, n: int | None = None,
                   dtype: Any = None, *, label: str | None = None,
                   device=None) -> "TuneSpec | None":
        """The :class:`TuneSpec` of one call, the geometry that runs.

        Three layers, later wins: the layout defaults
        (``layout.DEFAULT_TUNING["gpu"]``), the autotune table's swept
        winner for this call's bucket (the section of ``device``), and this
        policy's ``op_tuning``. A knob of ``op_tuning`` that no Hopper
        kernel takes (``attention.block_q``) warns once and is dropped.
        Only the knobs the code that runs under ``label`` takes are kept
        (``layout.kernel_knobs``: the SSD chunk under ``tile_gpu``, the
        blocks and tree under ``tile_logdepth``, none for a plain version
        or a torch form), clamped against ``n``. None for a call with no
        op.
        """
        if op is None:
            return None
        op = OP_ALIASES.get(op, op)
        if op not in KNOWN_OPS:
            return None
        if not KNOB_SCHEMA[op]:
            return TuneSpec(op)
        from repro_torch.kernels import layout  # deferred: avoids a cycle

        knobs = layout.default_tuning("gpu", op)
        taken = set(knobs)
        if n is not None and self.autotune != "off":
            from repro_torch.core import autotune  # deferred: imports us

            swept = autotune.tuning_entry(op, n, dtype, policy=self,
                                          device=device)
            if swept:
                knobs.update(swept)
        for name, spec in self.op_tuning:
            if name != op:
                continue
            for k, v in spec.knobs:
                if k in taken:
                    knobs[k] = v
                else:
                    warn_once(
                        f"knob:{op}.{k}",
                        f"tuning knob {op}.{k} is not taken by any Hopper "
                        "kernel of the port (it shapes a Pallas or Triton "
                        "tile of the reference); it is ignored and left "
                        "out of the resolved spec", UserWarning)
        keep = layout.kernel_knobs(str(label), op)
        knobs = {k: v for k, v in knobs.items() if k in keep}
        return TuneSpec(op, layout.clamp_spec("gpu", op, knobs, n=n))

    def resolve(self, op: str | None = None, n: int | None = None,
                dtype: Any = None, *, level: str = "dispatch",
                explicit: str | None = None,
                device=None) -> "ResolvedPath":
        """Resolve one call to a concrete path.

        ``op``/``n``/``dtype`` describe the call's shape: with them
        ``auto`` consults the measured table (or its heuristic) of the
        section ``device`` keys. ``level`` is ``"dispatch"`` or
        ``"kernel"`` (policy-sourced ``xla_tile``/``baseline`` become
        ``fused``, the kernel's plain version). ``explicit`` is a per-call
        label that beats the policy, validated against ``level``'s labels.
        ``device`` is the call's tensor device (None: the process's
        default, the CUDA card where there is one).

        Under an active ``repro_torch.parallel.MeshContext`` the bucket is
        the shard's: ``n`` divided by the context's shard divisor for
        ``op`` (``mesh_context.effective_call_n``), and the memo keys off
        that n.

        Returns a :class:`ResolvedPath` whose ``.tuning`` is the
        :class:`TuneSpec` of :meth:`tuning_for`. Memoised (see the module
        docstring); the ``resolution`` event fires on every call.
        """
        n_raw = n
        if _MESH_ACTIVE.get() is not None and op is not None \
                and n is not None:
            n = _mesh.effective_call_n(op, n)
        key = (self, op, n, dtype, level, explicit, device)
        try:
            resolved = _MEMO.get(key)
        except TypeError:          # an unhashable dtype or device
            key, resolved = None, None
        if resolved is None:
            label = self._resolve_label(op=op, n=n, dtype=dtype, level=level,
                                        explicit=explicit, device=device)
            resolved = ResolvedPath(label, self.tuning_for(
                op, n, dtype, label=label, device=device))
            if key is not None:
                if len(_MEMO) >= _MEMO_MAX:
                    _MEMO.clear()
                _MEMO[key] = resolved
        if _obs.ACTIVE is not None:   # observability off by default: the
            # disabled path costs one module-global load and this branch
            self._emit_resolution(op=op, n_raw=n_raw, n=n, dtype=dtype,
                                  level=level, explicit=explicit,
                                  resolved=resolved, device=device)
        return resolved

    def _emit_resolution(self, *, op, n_raw, n, dtype, level, explicit,
                         resolved: "ResolvedPath", device) -> None:
        """One ``resolution`` event (``RESOLUTION_FIELDS``) and a
        ``repro_resolutions_total`` count: ``n`` is the caller's bucket
        size, ``shard_n`` the one resolution keyed off (the shard's under a
        mesh context) and ``shard_divisor`` their ratio."""
        sess = _obs.ACTIVE
        if sess is None:   # raced a disable(); nothing to record into
            return
        from repro_torch.core import autotune  # deferred: imports us

        shaped = op is not None and n is not None
        sess.emit(
            "resolution",
            op=op, n=n_raw, shard_n=n,
            shard_divisor=max(1, n_raw // n) if shaped and n else 1,
            dtype=autotune.dtype_tag(dtype) if shaped else None,
            backend=autotune.current_backend(device),
            band=autotune.band(n) if shaped else None,
            level=level, explicit=explicit, chosen_path=str(resolved),
            tuning=(resolved.tuning.as_dict()
                    if resolved.tuning is not None else None),
            table_src=self.table_src(op, n, dtype, explicit=explicit,
                                     device=device))
        sess.counter(
            "repro_resolutions_total",
            "KernelPolicy.resolve() calls by op/path/level").inc(
            op=str(op), path=str(resolved), level=str(level))

    def table_src(self, op, n, dtype, *, explicit=None, device=None) -> str:
        """What decided an ``auto``: ``"none"`` (no ``auto`` requested),
        ``"static"`` (no shape, or autotune off), the table's path (the
        bucket is in the device's section) or ``"heuristic"``."""
        from repro_torch.core import autotune  # deferred: imports us

        requested = explicit if explicit is not None else self.for_op(op)
        if requested != "auto":
            return "none"
        if op is None or n is None or self.autotune == "off":
            return "static"
        entries = autotune.current_entries(self, device=device)
        if entries is not None and \
                autotune.bucket_key(op, n, dtype) in entries:
            return str(autotune.table_path(self))
        return "heuristic"

    def _resolve_label(self, op: str | None, n: int | None, dtype: Any,
                       level: str, explicit: str | None, device) -> str:
        from repro_torch.kernels import backend as kb  # deferred

        valid = DISPATCH_PATHS if level == "dispatch" else KERNEL_PATHS
        if explicit is not None:
            if explicit not in valid:
                noun = "path" if level == "dispatch" else "kernel path"
                raise ValueError(
                    f"unknown {noun} {explicit!r}; expected one of {valid}")
            label = explicit
        else:
            label = self.for_op(op)
            if level == "kernel" and label in _DISPATCH_ONLY:
                label = "fused"
        native = kb.native_tile_backend(device)
        where = device if device is not None else "the default device"
        if native is None and label in ("auto", "tile", "tile_logdepth") \
                and self.backend != "cpu" and kb.on_gpu(device):
            # a CUDA tensor on a card the kernels are not built for: fail
            # loudly rather than run the plain versions in their place
            raise RuntimeError(
                f"path={label!r} on a tensor on {where}: the port's kernels "
                "are built for sm_90a and need a CUDA card of compute "
                "capability 9.0; pass path='interpret' (the plain versions) "
                "or 'fused' (the torch forms) to run without them")
        if label == "auto":
            choice = None
            if op is not None and n is not None:
                from repro_torch.core import autotune  # deferred

                if level == "kernel":
                    canon = OP_ALIASES.get(op, op)
                    choice = autotune.choose(
                        op, n, dtype,
                        candidates=("fused", "tile", "tile_tpu", "tile_gpu",
                                    "tile_logdepth", "interpret"),
                        level="kernel", policy=self, device=device,
                        use_heuristic=(canon
                                       not in autotune.FUSED_DEFAULT_OPS))
                else:
                    choice = autotune.choose(op, n, dtype, policy=self,
                                             device=device)
                # auto never forces a tile backend the device has not
                if choice in ("tile_tpu", "tile_gpu") and choice != native:
                    choice = None
            label = choice or ("tile" if native else "fused")
            if level == "kernel" and label in _DISPATCH_ONLY:
                label = "fused"
        if label in _DISPATCH_ONLY:
            return label
        if label == "tile":
            if self.backend == "cpu":
                return "interpret"   # an explicit CPU choice, no downgrade
            if self.backend in ("gpu", "tpu"):
                label = f"tile_{self.backend}"   # strict checks below
            elif native is None:
                if self.interpret_fallback == "error":
                    raise RuntimeError(
                        f"path='tile' has no Hopper kernel for a tensor on "
                        f"{where} and this policy's interpret_fallback="
                        "'error' forbids running the plain version")
                if self.interpret_fallback == "warn":
                    _warn_tile_downgrade(where)
                return "interpret"
            else:
                return native
        if label == "tile_logdepth":
            if native is None and self.backend != "cpu":
                if self.interpret_fallback == "error":
                    raise RuntimeError(
                        "path='tile_logdepth' has no Hopper kernel for a "
                        f"tensor on {where} and this policy's "
                        "interpret_fallback='error' forbids running its "
                        "local block passes' plain versions")
                if self.interpret_fallback == "warn":
                    _warn_logdepth_downgrade(where)
            return label
        if label == "tile_tpu":
            raise RuntimeError(
                "path='tile_tpu' needs the reference's Pallas-TPU kernels; "
                "the port has no TPU route. Use path='tile' (the Hopper "
                "kernel on a CUDA tensor) or path='interpret' (the plain "
                "version)")
        if label == "tile_gpu" and native != "tile_gpu":
            raise RuntimeError(
                f"path='tile_gpu' needs a tensor on a CUDA card of compute "
                f"capability 9.0 (got one on {where}); use "
                "path='interpret' for the plain version or path='tile' for "
                "the device's choice")
        return label


# ---------------------------------------------------------------------------
# memos


_MEMO: dict[tuple, ResolvedPath] = {}
_MEMO_MAX = 1 << 14


@functools.lru_cache(maxsize=512)
def _from_string(spec: str, base: KernelPolicy) -> KernelPolicy:
    """The string forms of :meth:`KernelPolicy.from_spec` (memoised: an
    eager op pays a dictionary lookup for a string policy, not a parse)."""
    s = spec.strip()
    if s.startswith("{"):
        fields = json.loads(s)
        if not isinstance(fields, dict):
            raise ValueError(f"policy JSON must be an object, got: {s!r}")
        return dataclasses.replace(base, **fields)
    if "=" in s:
        overrides = dict(base.op_paths)
        tuning = {op: ts.as_dict() for op, ts in base.op_tuning}
        path = base.path
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                key, _, val = part.partition("=")
                key = key.strip()
                if "." in key:      # op.knob=value tuning override
                    op, _, kn = key.partition(".")
                    op = OP_ALIASES.get(op.strip(), op.strip())
                    tuning.setdefault(op, {})[kn.strip()] = int(val)
                else:
                    overrides[key] = val.strip()
            else:
                path = part
        return dataclasses.replace(
            base, path=path, op_paths=tuple(overrides.items()),
            op_tuning=tuning)
    return dataclasses.replace(base, path=s, op_paths=())


def invalidate_cache() -> None:
    """Forget every memoised resolution (a table was rewritten, the env
    changed, a test reset a one-time warning)."""
    _MEMO.clear()


# ---------------------------------------------------------------------------
# the process default (built from the env vars — the ONLY place they are
# read) and the context-var active policy


_DEFAULT_CACHE: dict[tuple, KernelPolicy] = {}
_DEFAULT_RAW: list = [None]
_ENV_NAMES = (ENV_PATH, ENV_AUTOTUNE, ENV_TABLE)


def default_policy() -> KernelPolicy:
    """The process-default policy, built from the env vars: parsed once per
    distinct env state (tests that monkeypatch the environment see the
    change), which also clears the resolution memo."""
    state = tuple(os.environ.get(k) for k in _ENV_NAMES)
    pol = _DEFAULT_CACHE.get(state)
    if pol is not None and state == _DEFAULT_RAW[0]:
        return pol
    _DEFAULT_RAW[0] = state
    invalidate_cache()
    if pol is None:
        raw = tuple("" if v is None else v for v in state)
        mode = "off" if raw[1].strip().lower() in (
            "off", "0", "static", "false") else "on"
        table = raw[2].strip() or None
        pol = KernelPolicy(autotune=mode, autotune_table=table)
        spec = raw[0].strip()
        if spec:
            # the full from_spec grammar; JSON is case-sensitive, the
            # simple forms are lowercased
            if not spec.startswith("{"):
                spec = spec.lower()
            pol = KernelPolicy.from_spec(spec, base=pol)
        _DEFAULT_CACHE[state] = pol
    return pol


_ACTIVE: contextvars.ContextVar[KernelPolicy | None] = \
    contextvars.ContextVar("repro_kernel_policy", default=None)


def get_policy() -> KernelPolicy:
    """The active policy: the innermost override, else the env default."""
    pol = _ACTIVE.get()
    return pol if pol is not None else default_policy()


def set_policy(policy: "KernelPolicy | Mapping | str | None"
               ) -> contextvars.Token:
    """Install ``policy`` as the active policy (None restores the env
    default). Returns a token for :func:`reset_policy`; prefer the scoped
    :func:`using_policy`."""
    pol = None if policy is None else \
        KernelPolicy.from_spec(policy, base=get_policy())
    return _ACTIVE.set(pol)


def reset_policy(token: contextvars.Token) -> None:
    """Undo a :func:`set_policy` (restores the previous active policy)."""
    _ACTIVE.reset(token)


@contextlib.contextmanager
def using_policy(policy: "KernelPolicy | Mapping | str | None"
                 ) -> Iterator[KernelPolicy]:
    """Scoped policy override; nests and restores on exit."""
    token = set_policy(policy)
    try:
        yield get_policy()
    finally:
        reset_policy(token)


def coerce_config_policy(policy, kernel_path: str | None,
                         owner: str) -> KernelPolicy | None:
    """Shared ``__post_init__`` shim of the configs that hold a policy:
    folds the deprecated ``kernel_path=`` (warns once, keyed by ``owner``)
    into ``policy`` and coerces strings and mappings absolutely (a config
    must not capture whatever policy is active at its construction).
    Returns the policy, or None (= the active policy at call time)."""
    if kernel_path is not None:
        warn_once(
            f"deprecated:{owner}.kernel_path",
            f"{owner}(kernel_path=...) is deprecated; pass policy= "
            "(a KernelPolicy or a path-label string)", stacklevel=5)
        if policy is None:
            policy = kernel_path
    if policy is not None and not isinstance(policy, KernelPolicy):
        policy = KernelPolicy.from_spec(policy)
    return policy


def policy_from_cli(policy_arg: str | None, kernel_path_arg: str | None,
                    warn_key: str,
                    tune_arg: str | None = None) -> KernelPolicy | None:
    """The CLIs' ``--policy`` / ``--tune`` / deprecated ``--kernel-path``.

    ``--kernel-path <label>`` warns once and acts as ``--policy <label>``
    unless ``--policy`` was given too; ``--tune "op.knob=value,..."`` layers
    tuning overrides on the result. Applied over the env default (a CLI is a
    process entry point: the env vars keep steering what the flags leave).
    None when no flag was passed."""
    spec = policy_arg
    if kernel_path_arg is not None:
        warn_once(warn_key, "--kernel-path is deprecated; use --policy")
        spec = spec if spec is not None else kernel_path_arg
    if spec is None and tune_arg is None:
        return None
    pol = default_policy()
    if spec is not None:
        pol = KernelPolicy.from_spec(spec, base=pol)
    if tune_arg is not None:
        for part in tune_arg.split(","):
            part = part.strip()
            if part and "." not in part.split("=", 1)[0]:
                raise ValueError(
                    f"--tune expects op.knob=value pairs (e.g. "
                    f"'ssd.q=32'), got {part!r} — path overrides belong "
                    "in --policy")
        pol = KernelPolicy.from_spec(tune_arg, base=pol)
    return pol


def as_policy(policy: "KernelPolicy | Mapping | str | None" = None
              ) -> KernelPolicy:
    """Coerce a per-call ``policy=``: None is the active policy; a string or
    mapping overlays it (a bare label also clears per-op overrides)."""
    if policy is None:
        return get_policy()
    if isinstance(policy, KernelPolicy):
        return policy
    return KernelPolicy.from_spec(policy, base=get_policy())

