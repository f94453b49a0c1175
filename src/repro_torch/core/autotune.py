"""Shape-aware autotuning for the ``auto`` path of the port.

Counterpart of ``repro.core.autotune``. The paper's central result is a
crossover: the matmul form of a reduction or scan wins at small segments
and loses its lead as they grow. ``auto`` therefore consults a *measured*
table:

* **Buckets** — a call maps to ``{op}/{dtype-tag}/{log2-band}`` (e.g.
  ``reduce/f32/9`` for a 512-element f32 segmented reduce), the reference's
  keys.
* **Table** — a JSON file keyed by backend, the reference's v3 format:
  ``{"version": 3, "backends": {"cpu": {"torch": ..., "entries": {bucket:
  {"path": ..., "us": {...}, "tuning": {...}, "sweep": {...}}}}}}``. A
  section records the framework that measured it (``"torch"`` here,
  ``"jax"`` in the reference's files, which load too). The section read is
  the one of **the call's tensor device** (``gpu`` for a CUDA tensor, else
  ``cpu``), so a section measured on the card never steers a CPU tensor.
  v1 and v2 files up-convert on load. Resolution order: the policy's
  ``autotune_table`` (``$REPRO_AUTOTUNE_TABLE``) > the checked-in default
  (``autotune_default.json``, whose one ``cpu`` section this module's
  ``--write`` measured) > :func:`heuristic`.
* **Harness** — :func:`measure_table` times every contender of
  ``repro_torch.core.dispatch`` per bucket on one device and records the
  argmin; where a kernel runs (or under ``sweep_interpret``) it also times
  ``tile`` and sweeps the log-depth candidates of ``kernels/layout``
  (``tile_logdepth:`` sweep keys), persisting the winning spec as
  ``"tuning"``. On the card each contender is timed with CUDA events over
  a batch of calls after a warm-up that takes the kernels' build out.
* **Fallbacks** — a missing bucket falls back to :func:`heuristic`;
  ``autotune="off"`` (``REPRO_AUTOTUNE=off``) disables table and heuristic.
  An explicitly requested table that is malformed fails loudly; only the
  implicit default degrades.

Every contender of an op agrees to tolerance, so the table only moves work
between formulations.
"""
from __future__ import annotations

import json
import math
import statistics
import time
from pathlib import Path
from typing import Any, Iterable, Sequence

import torch

from repro_torch.core import policy as kpolicy
from repro_torch.kernels import backend

ENV_AUTOTUNE = kpolicy.ENV_AUTOTUNE      # "off"/"0"/"static" -> static auto
ENV_TABLE = kpolicy.ENV_TABLE            # path to a JSON table
DEFAULT_TABLE_PATH = Path(__file__).with_name("autotune_default.json")
TABLE_VERSION = 3
_UPCONVERTIBLE_VERSIONS = (2,)   # v2 = backend sections, no tuning
MAX_BAND = 20

KNOWN_BACKENDS = ("cpu", "gpu", "tpu")

# the ops with a measured matmul-form vs native-op crossover
CROSSOVER_OPS = ("reduce", "scan", "weighted_scan",
                 "ragged_reduce", "ragged_scan")
# the reference's boundary where nothing was measured (paper Fig. 11)
HEURISTIC_CROSSOVER = 512

# Ops whose CPU ``auto`` keeps the fused form (the reference's reasons:
# those forms shard under GSPMD and carry knobs the Pallas kernels drop).
FUSED_DEFAULT_OPS = ("attention", "ssd")

_OP_ALIAS = dict(kpolicy.OP_ALIASES)

# the harness's grid, shared with check_default
DEFAULT_BANDS = tuple(range(4, 14))
DEFAULT_DTYPES = (torch.float32, torch.bfloat16)

# the contenders the harness times per op (dispatch-level paths); ``tile``
# is added where a kernel runs
OP_CONTENDERS = {
    "reduce": ("fused", "xla_tile", "baseline"),
    "scan": ("fused", "baseline"),
    "weighted_scan": ("fused", "baseline"),
    "ragged_reduce": ("fused", "baseline"),
    "ragged_scan": ("fused", "baseline"),
}


def current_backend(device=None) -> str:
    """The table section of ``device``: ``gpu`` for a CUDA device, ``cpu``
    otherwise; without one, the process's default device."""
    return "gpu" if backend.on_gpu(device) else "cpu"


# ---------------------------------------------------------------------------
# bucketing


def dtype_tag(dtype: Any) -> str:
    """Canonical short tag for a dtype (``f32``, ``bf16``, ...)."""
    if dtype is None:
        return "f32"
    name = str(dtype).rpartition(".")[2]
    return {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
            "float64": "f64"}.get(name, name)


_DTYPE_FROM_TAG = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "f16": torch.float16, "f64": torch.float64}


def dtype_from_tag(tag: str) -> torch.dtype:
    """Inverse of :func:`dtype_tag` (a resolution event carries the tag)."""
    return _DTYPE_FROM_TAG.get(tag) or getattr(torch, tag)


def band(n: int) -> int:
    """log2 segment-size band, clamped to [0, MAX_BAND]."""
    return max(0, min(int(math.log2(max(int(n), 1))), MAX_BAND))


def bucket_key(op: str, n: int, dtype: Any = None) -> str:
    return f"{_OP_ALIAS.get(op, op)}/{dtype_tag(dtype)}/{band(n)}"


# ---------------------------------------------------------------------------
# table load / save


_TABLE_CACHE: dict[str, dict | None] = {}


def invalidate_cache() -> None:
    """Forget the loaded tables and the resolutions made from them."""
    _TABLE_CACHE.clear()
    kpolicy.invalidate_cache()


def _valid_paths() -> tuple[str, ...]:
    # dispatch-level paths minus "auto" (a table is fully resolved)
    return ("fused", "xla_tile", "tile", "tile_tpu", "tile_gpu",
            "tile_logdepth", "interpret", "baseline")


def _check_entries(entries: Any, where: str) -> None:
    if not isinstance(entries, dict) or not entries:
        raise ValueError(f"autotune table {where}: no entries")
    ok = _valid_paths()
    for key, ent in entries.items():
        if not isinstance(ent, dict) or ent.get("path") not in ok:
            raise ValueError(
                f"autotune table {where}: entry {key!r} has invalid path "
                f"{ent.get('path') if isinstance(ent, dict) else ent!r}")
        tuning = ent.get("tuning")
        if tuning is None:
            continue
        op = key.split("/", 1)[0]
        allowed = kpolicy.KNOB_SCHEMA.get(op, ())
        if not isinstance(tuning, dict):
            raise ValueError(
                f"autotune table {where}: entry {key!r} tuning must be an "
                f"object, got {tuning!r}")
        for k, v in tuning.items():
            if k not in allowed:
                raise ValueError(
                    f"autotune table {where}: entry {key!r} has unknown "
                    f"tuning knob {k!r}; expected one of {allowed} — a "
                    "typo'd knob would silently no-op")
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                raise ValueError(
                    f"autotune table {where}: entry {key!r} tuning knob "
                    f"{k!r} must be a positive int, got {v!r}")


def _framework(section: dict) -> dict:
    """The section's record of what measured it (``torch`` or ``jax``)."""
    return {k: section[k] for k in ("torch", "jax") if k in section}


def load_table(path: str | Path) -> dict:
    """Load and validate a table; raises ValueError on a malformed file.

    Returns the v3 shape; v1 files (one flat ``backend``/``entries``) and
    v2 files (sections without ``tuning``) up-convert. Unknown backend keys
    and unknown tuning knobs are errors: a typo'd table must fail loudly,
    never steer nothing.
    """
    with open(path) as f:
        table = json.load(f)
    if not isinstance(table, dict):
        raise ValueError(f"autotune table {path}: not a JSON object")
    version = table.get("version")
    if version == 1:  # legacy single-backend layout
        bk = table.get("backend")
        bk = "gpu" if bk in ("cuda", "rocm") else bk  # old raw spellings
        if bk not in KNOWN_BACKENDS:
            raise ValueError(
                f"autotune table {path}: unknown backend key {bk!r}; "
                f"expected one of {KNOWN_BACKENDS}")
        _check_entries(table.get("entries"), str(path))
        return {"version": TABLE_VERSION,
                "backends": {bk: {**_framework(table),
                                  "entries": table["entries"]}}}
    if version in _UPCONVERTIBLE_VERSIONS:
        table = dict(table, version=TABLE_VERSION)
        version = TABLE_VERSION
    if version != TABLE_VERSION:
        raise ValueError(
            f"autotune table {path}: version {version!r} != {TABLE_VERSION}")
    backends = table.get("backends")
    if not isinstance(backends, dict) or not backends:
        raise ValueError(f"autotune table {path}: no backend sections")
    for bk, section in backends.items():
        if bk not in KNOWN_BACKENDS:
            raise ValueError(
                f"autotune table {path}: unknown backend key {bk!r}; "
                f"expected one of {KNOWN_BACKENDS}")
        if not isinstance(section, dict):
            raise ValueError(
                f"autotune table {path}: backend {bk!r} section is not an "
                "object")
        _check_entries(section.get("entries"), f"{path} [{bk}]")
    return table


def save_table(table: dict, path: str | Path) -> None:
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    invalidate_cache()


def merge_tables(base: dict | None, new: dict) -> dict:
    """Overlay ``new``'s backend sections onto ``base``: a table measured
    on the card drops into the checked-in default as a ``gpu`` section and
    leaves the ``cpu`` one as it was."""
    merged = {"version": TABLE_VERSION, "backends": {}}
    if base is not None:
        merged["backends"].update(base.get("backends", {}))
    merged["backends"].update(new.get("backends", {}))
    return merged


def _entry_us(ent: dict) -> float:
    """The winning path's measured time of one entry (inf without one)."""
    us = ent.get("us")
    if isinstance(us, dict):
        t = us.get(ent.get("path"))
        if isinstance(t, (int, float)):
            return float(t)
    return math.inf


def merge_host_tables(paths: Sequence[str | Path]) -> dict:
    """Fold per-host tables into one at entry granularity: the union of the
    buckets, a bucket two hosts measured going to the faster winning time;
    each entry records its file under ``"src"``."""
    if not paths:
        raise ValueError("merge_host_tables: no input tables")
    merged: dict = {"version": TABLE_VERSION, "backends": {}}
    for path in paths:
        table = load_table(path)
        src = Path(path).name
        for bk, section in table["backends"].items():
            out = merged["backends"].setdefault(
                bk, {**_framework(section), "entries": {}})
            for key, ent in section["entries"].items():
                ent = dict(ent, src=src)
                have = out["entries"].get(key)
                if have is None or _entry_us(ent) < _entry_us(have):
                    out["entries"][key] = ent
    return merged


def table_path(policy: kpolicy.KernelPolicy | None = None) -> Path | None:
    """The active table file: the policy's ``autotune_table``, else the
    checked-in default."""
    pol = policy if policy is not None else kpolicy.get_policy()
    if pol.autotune_table:
        return Path(pol.autotune_table)
    return DEFAULT_TABLE_PATH if DEFAULT_TABLE_PATH.exists() else None


def current_table(policy: kpolicy.KernelPolicy | None = None) -> dict | None:
    """The active, validated table (cached per path), or None. An explicit
    table that fails to load raises; the implicit default degrades to
    None."""
    pol = policy if policy is not None else kpolicy.get_policy()
    path = table_path(pol)
    if path is None:
        return None
    explicit = bool(pol.autotune_table)
    key = str(path)
    if key not in _TABLE_CACHE:
        try:
            _TABLE_CACHE[key] = load_table(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            if explicit:
                raise ValueError(
                    f"{ENV_TABLE}={path} is unusable: {e}") from e
            _TABLE_CACHE[key] = None
    return _TABLE_CACHE[key]


def current_entries(policy: kpolicy.KernelPolicy | None = None, *,
                    device=None) -> dict | None:
    """The active table's entries for ``device``'s section, or None."""
    table = current_table(policy)
    if table is None:
        return None
    section = table["backends"].get(current_backend(device))
    return section["entries"] if section else None


def enabled(policy: kpolicy.KernelPolicy | None = None) -> bool:
    """False when the policy asks for the static choice (``autotune="off"``,
    i.e. ``REPRO_AUTOTUNE=off``)."""
    pol = policy if policy is not None else kpolicy.get_policy()
    return pol.autotune != "off"


# ---------------------------------------------------------------------------
# resolution


def heuristic(op: str, n: int, dtype: Any = None,
              candidates: Iterable[str] | None = None, *,
              device=None) -> str:
    """Deterministic shape-aware fallback.

    On a tensor a Hopper kernel runs on it answers ``tile`` for every op:
    that is what the port runs today, and a measured ``gpu`` section is how
    ``auto`` leaves it. The reference's GPU branch is not taken over. Its
    two reasons concern Pallas-Triton, not these kernels: the attention and
    SSD kernels do not fall back on unaligned lengths and take no knob the
    torch forms carry (``FUSED_DEFAULT_OPS``), and its crossover at 512 was
    measured for Triton kernels against XLA's ops. Elsewhere it is the
    reference's CPU branch, line for line: attention and the SSD keep the
    fused form, the crossover ops go to the native op past 512, everything
    else is ``fused``.
    """
    op = _OP_ALIAS.get(op, op)
    if backend.native_tile_backend(device) == "tile_gpu":
        want = "tile"
    elif op in FUSED_DEFAULT_OPS:
        want = "fused"
    elif op in CROSSOVER_OPS and n > HEURISTIC_CROSSOVER:
        want = "baseline"
    else:
        want = "fused"
    if candidates is not None:
        cands = tuple(candidates)
        if want not in cands:
            for fb in ("fused", "tile", "interpret", "baseline"):
                if fb in cands:
                    return fb
    return want


# dispatch-level labels -> the kernel-level implementation that runs the
# same code: the kernel level's "fused" is the plain version, i.e. the
# dispatch level's "baseline"; the matmul forms have no kernel-level twin
_KERNEL_EQUIV = {"baseline": "fused", "tile": "tile",
                 "tile_tpu": "tile_tpu", "tile_gpu": "tile_gpu",
                 "tile_logdepth": "tile_logdepth", "interpret": "interpret"}


def _backend_compatible(path: str, device=None) -> bool:
    """A table entry steers only onto a kernel ``device`` runs."""
    if path in ("tile_tpu", "tile_gpu"):
        return backend.native_tile_backend(device) == path
    return True


def choose(op: str, n: int, dtype: Any = None,
           candidates: Iterable[str] | None = None, *,
           level: str = "dispatch",
           policy: kpolicy.KernelPolicy | None = None,
           use_heuristic: bool = True, device=None) -> str | None:
    """Resolve ``auto`` for one call shape on ``device``: the table entry
    of its section, else :func:`heuristic` (unless ``use_heuristic`` is
    False); None when the policy turns autotuning off. ``level="kernel"``
    maps the table's dispatch-level labels onto the kernel level
    (``_KERNEL_EQUIV``), taking the fastest recorded contender with a twin
    when the winner has none."""
    if not enabled(policy):
        return None
    entries = current_entries(policy, device=device)
    if entries is not None:
        ent = entries.get(bucket_key(op, n, dtype))
        if ent is not None and _backend_compatible(ent["path"], device):
            if level == "kernel":
                if ent["path"] in _KERNEL_EQUIV:
                    return _KERNEL_EQUIV[ent["path"]]
                us = {k: v for k, v in (ent.get("us") or {}).items()
                      if k in _KERNEL_EQUIV}
                if us:
                    return _KERNEL_EQUIV[min(us, key=us.get)]
            else:
                path = ent["path"]
                if candidates is None or path in tuple(candidates):
                    return path
    if not use_heuristic:
        return None
    return heuristic(op, n, dtype, candidates, device=device)


def tuning_entry(op: str, n: int, dtype: Any = None, *,
                 policy: kpolicy.KernelPolicy | None = None,
                 device=None) -> dict | None:
    """The swept winning knobs of one call shape in ``device``'s section,
    or None (the layout defaults apply)."""
    if not enabled(policy):
        return None
    entries = current_entries(policy, device=device)
    if entries is None:
        return None
    ent = entries.get(bucket_key(op, n, dtype))
    tuning = ent.get("tuning") if ent else None
    return dict(tuning) if tuning else None


# ---------------------------------------------------------------------------
# measurement harness


def _time_fn(fn, device: torch.device, *, iters: int = 3, warmup: int = 1,
             reps: int = 1) -> float:
    """Median seconds per call of ``fn``. On a CUDA device a sample is a
    pair of CUDA events around ``reps`` calls (so the host's enqueue is in
    it when the host is the slower side, as it is for a user), after
    ``warmup`` calls that take the kernels' build and first launch out; on
    the CPU a sample is one call on the host clock."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3 / reps)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _bench_inputs(op: str, n: int, dtype, gen: torch.Generator,
                  device: torch.device):
    """Representative arguments for one (op, segment-size) bucket, the
    reference's shapes: about 2^16 elements in rows of n."""
    rows = max(4, min(4096, (1 << 16) // n))

    def normal(*shape):
        return torch.randn(*shape, generator=gen).to(device, dtype)

    if op in ("reduce", "scan"):
        return (normal(rows, n),)
    if op == "weighted_scan":
        la = -torch.rand(rows, n, generator=gen)
        return normal(rows, n), la.to(device, dtype)
    if op in ("ragged_reduce", "ragged_scan"):
        s = min(128, max(2, n // 16))
        seg = torch.sort(torch.randint(0, s, (n,), generator=gen)).values
        return normal(n), seg.to(device), s
    raise ValueError(op)


def _fitted(specs: list[dict], op: str, n: int) -> list[dict]:
    """The candidates clamped against the bucket's n, duplicates dropped:
    two specs that run one geometry must not be timed as two (the winner
    between them would be noise that never ran)."""
    from repro_torch.kernels import layout

    out: list[dict] = []
    for spec in specs:
        ex = layout.clamp_spec("gpu", op, spec, n=n)
        if all(ex != e for e in out):
            out.append(ex)
    return out


def measure_table(
    *,
    ops: Iterable[str] = tuple(OP_CONTENDERS),
    bands: Iterable[int] = DEFAULT_BANDS,
    dtypes: Iterable[Any] = DEFAULT_DTYPES,
    iters: int = 3,
    sweep_interpret: bool = False,
    max_candidates: int | None = None,
    device=None,
    reps: int = 1,
) -> dict:
    """Time every contender per (op, dtype, band) bucket on ``device``
    (None: the process's default) -> a v3 table with one section.

    Runs through ``repro_torch.core.dispatch``, the entry every caller
    uses. Where a kernel runs, ``tile`` joins the contenders; the linear
    reduce and scans take no knob, so it is timed at its one geometry. For
    scan and weighted_scan ``tile_logdepth`` is swept over
    ``layout.logdepth_candidate_tuning`` (clamped and deduplicated), its
    timings kept under ``tile_logdepth:`` keys of ``"sweep"``, and the
    faster tile-family spec persisted as ``"tuning"``.
    ``sweep_interpret=True`` runs the log-depth sweep on the plain local
    passes where no kernel runs (the CLI's tiny smoke mode). ``reps`` calls
    make one CUDA-event sample on the card.
    """
    from repro_torch.core import dispatch  # deferred: dispatch imports us
    from repro_torch.kernels import layout

    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else (device or "cpu"))
    fns = {
        "reduce": dispatch.reduce,
        "scan": dispatch.scan,
        "weighted_scan": dispatch.weighted_scan,
        "ragged_reduce": dispatch.ragged_reduce,
        "ragged_scan": dispatch.ragged_scan,
    }
    native = backend.native_tile_backend(dev)
    ld_path = "tile_logdepth" if (native or sweep_interpret) else None
    entries: dict[str, dict] = {}
    gen = torch.Generator().manual_seed(0)
    for op in ops:
        contenders = OP_CONTENDERS[op]
        ld_specs = layout.logdepth_candidate_tuning("gpu", op)
        if max_candidates is not None:
            ld_specs = ld_specs[:max_candidates]
        for dtype in dtypes:
            for b in bands:
                n = 1 << b
                args = _bench_inputs(op, n, dtype, gen, dev)

                def timed(policy, args=args, op=op):
                    if op in ("ragged_reduce", "ragged_scan"):
                        x, seg, s = args
                        fn = lambda: fns[op](x, seg, s, policy=policy)  # noqa: E731
                    else:
                        fn = lambda: fns[op](*args, policy=policy)  # noqa: E731
                    return _time_fn(fn, dev, iters=iters, reps=reps)

                timings = {path: timed(path) for path in contenders}
                if native and op in ("reduce", "scan", "weighted_scan"):
                    timings["tile"] = timed("tile")
                best_spec = sweep_us = None
                if ld_specs and ld_path is not None:
                    sweep_us, persist = {}, {}
                    for ex in _fitted(ld_specs, op, n):
                        pol = kpolicy.KernelPolicy(
                            path=ld_path, autotune="off",
                            op_tuning={op: ex},
                            interpret_fallback="silent")
                        label = ("tile_logdepth:"
                                 + kpolicy.TuneSpec(op, ex).label())
                        sweep_us[label] = timed(pol)
                        persist[label] = ex
                    best = min(sweep_us, key=sweep_us.get)
                    timings[ld_path] = sweep_us[best]
                    best_spec = persist[best]
                winner = min(timings, key=timings.get)
                ent = {
                    "path": winner,
                    "us": {k: round(v * 1e6, 2) for k, v in timings.items()},
                }
                if best_spec is not None:
                    ent["tuning"] = dict(sorted(best_spec.items()))
                    ent["sweep"] = {k: round(v * 1e6, 2)
                                    for k, v in sweep_us.items()}
                entries[bucket_key(op, n, dtype)] = ent
    return {
        "version": TABLE_VERSION,
        "backends": {current_backend(dev): {"torch": torch.__version__,
                                            "entries": entries}},
    }


def _grid() -> set[str]:
    return {bucket_key(op, 1 << b, dtype) for op in OP_CONTENDERS
            for dtype in DEFAULT_DTYPES for b in DEFAULT_BANDS}


def check_default(default_path: str | Path = DEFAULT_TABLE_PATH, *,
                  backend_key: str | None = None,
                  require_all: bool = True) -> list[str]:
    """Structural staleness check of a table: it parses and validates, and
    its section for ``backend_key`` (None: the process's default device)
    holds exactly the harness's bucket set (with ``require_all=False``,
    no bucket outside it: a table a partial sweep wrote). Winning paths
    are machine-dependent and not compared. Returns the problems (empty:
    fresh)."""
    problems: list[str] = []
    try:
        table = load_table(default_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return [f"unparseable: {e}"]
    bk = backend_key or current_backend()
    section = table["backends"].get(bk)
    if section is None:
        return [f"no section for this host's backend {bk!r} "
                f"(have: {sorted(table['backends'])})"]
    want, have = _grid(), set(section["entries"])
    if require_all and (missing := sorted(want - have)):
        problems.append(f"missing buckets: {missing}")
    if extra := sorted(have - want):
        problems.append(f"stale buckets: {extra}")
    return problems


def describe_bucket(key: str, ent: dict | None = None) -> str:
    """One line for a table bucket in the obs resolution format: with
    ``ent`` what the table recorded, without it what the default policy
    resolves for the bucket today on the process's default device."""
    from repro_torch.obs import events as _ev

    op, tag, b = key.split("/")
    n = 1 << int(b)
    if ent is not None:
        event = {"op": op, "n": n, "dtype": tag, "band": int(b),
                 "backend": current_backend(),
                 "chosen_path": ent.get("path"),
                 "tuning": ent.get("tuning") or {},
                 "table_src": "table-entry"}
        return f"{_ev.format_resolution(event)} us={_entry_us(ent):.2f}"
    probe = kpolicy.KernelPolicy(interpret_fallback="silent")
    try:
        resolved = probe.resolve(op=op, n=n, dtype=dtype_from_tag(tag))
    except (RuntimeError, ValueError) as e:
        return f"op={op} n={n} dtype={tag}: unresolvable here ({e})"
    return _ev.format_resolution({
        "op": op, "n": n, "dtype": tag, "band": int(b),
        "backend": current_backend(), "chosen_path": str(resolved),
        "tuning": (resolved.tuning.as_dict()
                   if resolved.tuning is not None else {}),
        "table_src": "heuristic"})


def check_report(default_path: str | Path = DEFAULT_TABLE_PATH, *,
                 backend_key: str | None = None) -> list[str]:
    """Per-bucket detail behind ``--check``: a :func:`describe_bucket` line
    for every missing bucket (what resolves today) and stale bucket (what
    the table recorded)."""
    lines: list[str] = []
    try:
        table = load_table(default_path)
    except (OSError, ValueError, json.JSONDecodeError):
        return lines
    section = table["backends"].get(backend_key or current_backend())
    if section is None:
        return lines
    want, have = _grid(), set(section["entries"])
    for key in sorted(want - have):
        lines.append(f"  missing {key}: today -> {describe_bucket(key)}")
    for key in sorted(have - want):
        lines.append(f"  stale   {key}: table -> "
                     f"{describe_bucket(key, section['entries'][key])}")
    return lines


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Measure or check the port's autotune table.")
    ap.add_argument("--write", action="store_true",
                    help="measure the device's section and merge it into "
                         "the table file at --out")
    ap.add_argument("--out", default=None,
                    help="the table --write writes and --check checks "
                         f"(default: {DEFAULT_TABLE_PATH.name}, checked in)")
    ap.add_argument("--check", action="store_true",
                    help="verify the table parses and holds the harness's "
                         "bucket set (a table at --out may be partial); "
                         "exit 1 if not")
    ap.add_argument("--merge", nargs="+", metavar="TABLE",
                    help="fold per-host tables into one at --out")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="device to measure on (default: the CUDA card "
                         "where there is one, else the CPU)")
    ap.add_argument("--sweep-budget", choices=("full", "tiny"),
                    default="full",
                    help="'full' measures the whole grid; 'tiny' is the "
                         "smoke mode: reduce and the scans at bands 8 and "
                         "10, f32, one sample, two log-depth candidates "
                         "(run on the plain local passes where no kernel "
                         "runs)")
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else DEFAULT_TABLE_PATH

    if args.merge:
        table = merge_host_tables(args.merge)
        save_table(table, out)
        load_table(out)  # round trip: the merged file must validate
        sections = {bk: len(sec["entries"])
                    for bk, sec in table["backends"].items()}
        print(f"merged {len(args.merge)} host tables into {out} "
              f"(buckets per backend: {sections})")
        return 0
    if args.check:
        bk = current_backend(args.device)
        problems = check_default(out, backend_key=bk,
                                 require_all=args.out is None)
        for p in problems:
            print(f"STALE: {p}")
        for line in check_report(out, backend_key=bk):
            if args.out is None or line.startswith("  stale"):
                print(line)
        if not problems:
            print(f"autotune table OK ({out}, section {bk!r})")
        return 1 if problems else 0
    if args.write:
        if args.sweep_budget == "tiny":
            measured = measure_table(
                ops=("reduce", "scan", "weighted_scan"), bands=(8, 10),
                dtypes=(torch.float32,), iters=1, sweep_interpret=True,
                max_candidates=2, device=args.device)
        else:
            measured = measure_table(iters=args.iters, device=args.device)
        base = None
        if out.exists():
            try:
                base = load_table(out)
            except (OSError, ValueError, json.JSONDecodeError):
                base = None  # overwrite an unusable file
        table = merge_tables(base, measured)
        save_table(table, out)
        (bk,) = measured["backends"]
        n = len(table["backends"][bk]["entries"])
        print(f"wrote {n} buckets for backend={bk} to {out} "
              f"(sections: {sorted(table['backends'])}, "
              f"torch={torch.__version__})")
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
