"""Runtime program and transfer sentinels.

Port of ``deepspeed_tpu/profiling/sentinels.py``, with the same names:

- ``CompileSentinel`` wraps a hot function and fails loudly when it has
  run more programs than its budget. PyTorch eager has no jit cache, so a
  *program* here is one distinct call signature of a function decorated
  with ``records_programs``: the shape, dtype and device of every tensor
  (and numpy array) argument, the parameter signature of a module, and
  the value of every other argument, which is what ``jax.jit`` keys its
  cache on for the functions the JAX engines jit. These are also the
  graphs a CUDA-graph capture of the function would need, so a budget
  pins their number before graphs exist.
- ``transfer_free()`` runs a region under
  ``torch.cuda.set_sync_debug_mode("error")``: an implicit wait for the
  card (``.item()``, ``float()`` or ``bool()`` of a device tensor,
  ``nonzero``, a blocking ``.cpu()``, ``torch.tensor(..., device=cuda)``
  from host data, ``Stream.synchronize``) raises. Explicit transfers go
  through ``device_get`` / ``device_put`` inside a named
  ``allowed_transfer`` window, and ``transfer_counts`` counts them by
  name, so the host reads of a hot loop are visible, greppable calls
  whose number a test can pin.

The guard is narrower than JAX's. The sync-debug mode is one setting for
the whole process, where JAX's transfer guard is per thread, so a window
never lowers it: a sanctioned transfer is made of calls the mode does not
flag (a ``non_blocking`` copy to or from pinned memory, an event recorded
on the stream and ``Event.synchronize``), and a window only names the
traffic. A window that one thread opens therefore lets no other thread's
implicit sync through. But the calls the mode does not flag pass inside a
region whoever makes them: ``Event.synchronize``, ``Event.query``,
``torch.cuda.synchronize`` and a ``non_blocking`` copy to pageable host
memory all wait for the card unseen. The guard cannot tell such a wait
from a sanctioned one; ``transfer_counts`` is what pins the sanctioned
reads. ``transfer_free`` regions count their depth over the process, and
the mode returns to its earlier value when the last region exits.

On the CPU there is nothing to guard: the region still validates the
names, nests and restores its state.
"""

import dataclasses
import functools
import inspect
import threading
import weakref
from contextlib import contextmanager

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry

__all__ = [
    "CompileBudgetExceededError",
    "CompileSentinel",
    "allowed_transfer",
    "allowed_transfer_names",
    "compile_cache_size",
    "device_get",
    "device_put",
    "records_programs",
    "register_allowed_transfer",
    "reset_transfer_counts",
    "transfer_counts",
    "transfer_free",
]

# Named transfer allowlist: the only sanctioned escape from a
# transfer_free() region. A subsystem that must move data between host and
# card in a hot path registers its name at import time and opens
# allowed_transfer(name) around the traffic. An unregistered name raises.
_ALLOWED_TRANSFERS = set()
_ALLOWED_TRANSFERS_LOCK = threading.Lock()


def register_allowed_transfer(name):
    """Register ``name`` as a sanctioned transfer site (idempotent).

    Returns the name so call sites can do
    ``_H2D = register_allowed_transfer("zero/offload_h2d")``."""
    if not isinstance(name, str) or not name:
        raise ValueError(f"transfer allowlist name must be a non-empty str, got {name!r}")
    with _ALLOWED_TRANSFERS_LOCK:
        _ALLOWED_TRANSFERS.add(name)
    return name


def allowed_transfer_names():
    """Snapshot of the registered allowlist (for tests/telemetry)."""
    with _ALLOWED_TRANSFERS_LOCK:
        return frozenset(_ALLOWED_TRANSFERS)


# device_get / device_put calls by window name, since the last reset
_TRANSFERS = {}


def transfer_counts():
    """The sanctioned transfers (``device_get`` / ``device_put`` calls)
    made since the last ``reset_transfer_counts``, by window name."""
    with _ALLOWED_TRANSFERS_LOCK:
        return dict(_TRANSFERS)


def reset_transfer_counts():
    with _ALLOWED_TRANSFERS_LOCK:
        _TRANSFERS.clear()


@contextmanager
def allowed_transfer(name):
    """Open a sanctioned transfer window inside a ``transfer_free()`` region.

    ``name`` must have been registered with ``register_allowed_transfer``:
    an unknown name raises KeyError instead of silently allowing traffic.
    The window leaves the process's sync-debug mode as it is (see the
    module docstring): it names the traffic."""
    with _ALLOWED_TRANSFERS_LOCK:
        known = name in _ALLOWED_TRANSFERS
    if not known:
        raise KeyError(
            f"transfer site {name!r} is not on the allowlist — call "
            f"register_allowed_transfer({name!r}) at import time of the "
            f"subsystem that owns this traffic (registered: "
            f"{sorted(_ALLOWED_TRANSFERS)})")
    yield


def _count_transfer(name):
    with _ALLOWED_TRANSFERS_LOCK:
        _TRANSFERS[name] = _TRANSFERS.get(name, 0) + 1


def device_get(x, name):
    """The sanctioned device -> host read (the counterpart of
    ``jax.device_get``): opens the window ``name``, copies ``x`` into pinned
    host memory without blocking, and waits on an event recorded behind the
    copy. Returns a CPU tensor (``x`` itself when it already is one, or is
    no tensor). Counted under ``name`` in ``transfer_counts``."""
    with allowed_transfer(name):
        _count_transfer(name)
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type != "cuda":
            return x.detach().cpu()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x.detach(), non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
        done.synchronize()
        return host


def device_put(x, device, name, dtype=None):
    """The sanctioned host -> device upload: opens the window ``name`` and
    copies ``x`` (a CPU tensor, numpy array or list) from pinned memory
    without blocking. The pinned buffer is freed through the caching host
    allocator, which holds it until the copy has run. Counted under ``name``
    in ``transfer_counts``."""
    with allowed_transfer(name):
        _count_transfer(name)
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            dtype=dtype)
        device = torch.device(device)
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)


# -- programs ----------------------------------------------------------------

# a module's parameter signature, taken once: walking a large model's
# parameters at every call of a hot function would cost more than the call
_MODULE_SIGNATURES = weakref.WeakKeyDictionary()


def _signature(value):
    """The part of one argument a program is keyed on."""
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), value.dtype, str(value.device))
    if isinstance(value, np.ndarray):
        return ("array", value.shape, value.dtype.str)
    if isinstance(value, torch.nn.Module):
        sig = _MODULE_SIGNATURES.get(value)
        if sig is None:
            sig = _MODULE_SIGNATURES[value] = (
                "module", type(value).__qualname__,
                tuple((n, tuple(p.shape), p.dtype, str(p.device))
                      for n, p in value.named_parameters()))
        return sig
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(_signature(v) for v in value))
    if isinstance(value, dict):
        return ("dict", tuple(sorted((k, _signature(v)) for k, v in value.items())))
    if value is None or isinstance(value, (bool, int, float, str, torch.dtype,
                                           torch.device)):
        return value
    if dataclasses.is_dataclass(value):
        # a model config: its values, as jit keys a static argument
        return ("dataclass", type(value).__qualname__,
                tuple((f.name, _signature(getattr(value, f.name)))
                      for f in dataclasses.fields(value)))
    if callable(value):
        return ("callable", getattr(value, "__qualname__", repr(value)))
    # an object of state (a KV pool, a generator): its tensors are its operands
    tensors = tuple(sorted((k, _signature(v)) for k, v in getattr(value, "__dict__", {}).items()
                           if isinstance(v, torch.Tensor)))
    return ("object", type(value).__qualname__, tensors)


class _ProgramView:
    """The programs of a recorded function whose ``split`` argument takes
    one of ``values``: the counterpart of one of the JAX engine's jitted
    functions where the port runs several of them through one function."""

    def __init__(self, fn, values):
        self._fn = fn
        self._values = frozenset(values)
        self.__name__ = f"{fn.__name__}[{', '.join(sorted(map(str, values)))}]"

    def _cache_size(self):
        return self._fn._count(self._values)


def _traced_signature(value):
    """An argument JAX would trace (host ints, a list of positions): keyed
    by its shape and dtype, not its values."""
    if isinstance(value, torch.Tensor):
        return _signature(value)
    arr = np.asarray(value)
    return ("traced", arr.shape, arr.dtype.str)


def records_programs(fn=None, *, split=None, traced=()):
    """Decorate a hot function so that it records the distinct call
    signatures it has run (see the module docstring): their count is what
    ``compile_cache_size`` reads and ``CompileSentinel`` budgets.

    ``traced`` names arguments keyed by shape and dtype alone, as JAX
    traces them (a prompt, per-lane host offsets). ``split`` names an
    argument that selects a program class (a prefill's attention
    backend): ``fn.view(*values)`` then counts the programs of those
    classes alone."""
    if fn is None:
        return functools.partial(records_programs, split=split, traced=traced)
    seen = {}
    lock = threading.Lock()
    params = list(inspect.signature(fn).parameters.values())
    names = [p.name for p in params]
    at = names.index(split) if split in names else None

    def sig(name, value):
        return _traced_signature(value) if name in traced else _signature(value)

    def split_value(args, kwargs):
        if at is None:
            return None
        if at < len(args):
            return args[at]
        return kwargs.get(split, params[at].default)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        key = (tuple(sig(names[i] if i < len(names) else None, a)
                     for i, a in enumerate(args)),
               tuple(sorted((k, sig(k, v)) for k, v in kwargs.items())))
        with lock:
            seen.setdefault(key, split_value(args, kwargs))
        return fn(*args, **kwargs)

    def count(values=None):
        with lock:
            return sum(1 for v in seen.values() if values is None or v in values)

    wrapper._count = count
    wrapper._cache_size = count
    wrapper.view = lambda *values: _ProgramView(wrapper, values)
    return wrapper


class CompileBudgetExceededError(RuntimeError):
    """A CompileSentinel-wrapped function ran past its program budget."""

    def __init__(self, name, compiles, budget):
        self.name = name
        self.compiles = compiles
        self.budget = budget
        super().__init__(
            f"'{name}' compiled {compiles} program(s), budget is {budget} — "
            f"an operand that should be traced is varying statically "
            f"(shape, dtype, a non-tensor argument's value, or python structure).")


def compile_cache_size(fn):
    """Program count of a ``records_programs`` function (the distinct call
    signatures it has run). Raises TypeError for a callable that records
    none, as JAX's does for a function that is not jitted."""
    cache_size = getattr(fn, "_cache_size", None)
    if cache_size is None:
        raise TypeError(
            f"{getattr(fn, '__name__', fn)!r} records no programs "
            f"(_cache_size) — decorate it with records_programs")
    return cache_size()


class CompileSentinel:
    """Budgeted program watchdog around one recorded function.

    Counts programs as deltas since construction (or the last
    ``reset()``), so a warm signature never charges the budget. Call
    through it (``sentinel(*args)``: raises the moment the budget is
    exceeded), assert at the end of a scenario (``sentinel.check()``), or
    read ``sentinel.compiles``. Thread-safe to call through."""

    def __init__(self, fn, budget, name=None):
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        compile_cache_size(fn)     # validate up front, not at first call
        self._fn = fn
        self.budget = int(budget)
        self.name = name or getattr(fn, "__name__", "recorded function")
        self._lock = threading.Lock()
        self._baseline = compile_cache_size(fn)
        self._last_seen = 0

    @property
    def compiles(self):
        """New programs since construction / last reset()."""
        return max(0, compile_cache_size(self._fn) - self._baseline)

    def check(self):
        """Raise CompileBudgetExceededError past the budget; returns the
        current program count otherwise."""
        compiles = self.compiles
        if compiles > self._last_seen:
            telemetry.instant(
                "jax/recompile", cat="lifecycle",
                args={"name": self.name, "compiles": compiles,
                      "budget": self.budget})
            # the registry counterpart of the instant: an SLO rule like
            # {"metric": "Jax/recompiles_total", "max": N} alerts on it
            telemetry.get_registry().counter(
                "Jax/recompiles_total",
                help="recompiles observed by CompileSentinel.check").inc(
                compiles - self._last_seen)
            self._last_seen = compiles
        if compiles > self.budget:
            raise CompileBudgetExceededError(self.name, compiles, self.budget)
        return compiles

    def reset(self, budget=None):
        """Forgive past programs (after an intentional reshape) and
        optionally move the budget."""
        with self._lock:
            self._baseline = compile_cache_size(self._fn)
            self._last_seen = 0
            if budget is not None:
                if budget < 0:
                    raise ValueError(f"budget must be >= 0, got {budget}")
                self.budget = int(budget)

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self.check()
        return out

    def __getattr__(self, item):
        # transparent proxy: the wrapped function's attributes stay reachable
        return getattr(self._fn, item)

    def __repr__(self):
        return (f"CompileSentinel({self.name!r}, compiles={self.compiles}, "
                f"budget={self.budget})")


# -- transfer_free -------------------------------------------------------------

_GUARD_LOCK = threading.Lock()
_GUARD = {"depth": 0, "saved": None}
_LEVELS = ("warn", "error")


def _cuda_ready():
    return torch.cuda.is_available()


@contextmanager
def transfer_free(level="error"):
    """Run a region in which an implicit wait for the card raises
    (``level="error"``) or warns (``"warn"``): the sync-debug mode of
    ``torch.cuda``, armed while any thread is inside such a region and
    restored to its earlier value when the last one exits, an exception
    included. Explicit transfers go through ``device_get`` /
    ``device_put``. Waits the mode does not flag pass unseen:
    ``Event.synchronize`` / ``query``, ``torch.cuda.synchronize`` and a
    ``non_blocking`` copy to pageable memory (see the module docstring)."""
    if level not in _LEVELS:
        raise ValueError(f"transfer_free level must be one of {_LEVELS}, got {level!r}")
    with _GUARD_LOCK:
        if _GUARD["depth"] == 0 and _cuda_ready():
            _GUARD["saved"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(level)
        _GUARD["depth"] += 1
    try:
        yield
    finally:
        with _GUARD_LOCK:
            _GUARD["depth"] -= 1
            if _GUARD["depth"] == 0 and _GUARD["saved"] is not None:
                torch.cuda.set_sync_debug_mode(_GUARD["saved"])
                _GUARD["saved"] = None
