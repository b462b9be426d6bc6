"""The render's block stages as render_from_baked calls them, for checking
each stage's kernel against its plain twin: the table of the stages'
dispatches and twins, a recorder of one render's stage calls, a switch of
every dispatch to its twin, and the replay of a recorded call on copies of
its inputs. The render calls the stages through their modules
(``render_stages.scan(...)``), so patching a module's attribute reaches
every call. Used by chip_smoke.py and the stage tests; the render itself
does not import it."""

from __future__ import annotations

import contextlib

import torch

from . import compact, raymarch, render_stages

# stage -> (module, dispatch name, plain twin name), in the order of a render
STAGES = {
    "scan": (render_stages, "scan", "scan_plain"),
    "block_setup": (render_stages, "block_setup", "block_setup_plain"),
    "compact": (compact, "compact", "compact_plain"),
    "march_grid": (raymarch, "march_grid", "march_grid_plain"),
    "bracket": (render_stages, "bracket", "bracket_plain"),
    "march_rows": (raymarch, "march_rows", "march_rows_plain"),
    "hit_gather": (render_stages, "hit_gather", "hit_gather_plain"),
    "compose": (render_stages, "compose", "compose_plain"),
}


def copy(x):
    """A copy of a nested structure of tensors (tensors cloned, the rest
    shared)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(copy(v) for v in x)
    if isinstance(x, dict):
        return {k: copy(v) for k, v in x.items()}
    return x


def tensors(x):
    """The tensors of a nested structure, in order (None entries skipped,
    a dict's by sorted key)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors(x[k])]
    return []


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype, device and bits (float32 compared as int32)."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def all_bits_equal(got, want) -> bool:
    """:func:`bits_equal` over the tensors of two nested structures."""
    g, w = tensors(got), tensors(want)
    return len(g) == len(w) and all(bits_equal(x, y) for x, y in zip(g, w))


@contextlib.contextmanager
def _patched(replace):
    """Every stage's dispatch replaced by ``replace(stage, module, name)``
    while the context is open."""
    saved = []
    try:
        for stage, (mod, name, _) in STAGES.items():
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, replace(stage, mod, name))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def record_stages(render_frame):
    """[(stage, args, kwargs, result)] of every stage call the render
    ``render_frame()`` makes, in order, with copies of the inputs as the
    stage received them (some stages update arrays in place) and of its
    result; the calls still run."""
    calls = []

    def recorder(stage, mod, name):
        fn = getattr(mod, name)

        def record(*args, **kwargs):
            entry = [stage, copy(args), copy(kwargs), None]
            calls.append(entry)
            out = fn(*args, **kwargs)
            entry[3] = copy(out)
            return out
        return record

    with _patched(recorder):
        render_frame()
    return [tuple(c) for c in calls]


def plain_stages():
    """A context in which every stage's dispatch is its plain twin (a
    render then runs the twins on any device)."""
    return _patched(lambda stage, mod, name: getattr(mod, STAGES[stage][2]))


def stage_fn(stage: str, plain: bool):
    """``stage``'s plain twin or its dispatch, as the module holds it
    now."""
    mod, name, plain_name = STAGES[stage]
    return getattr(mod, plain_name if plain else name)


def replay(stage, args, kwargs, plain: bool):
    """(result, the inputs after the call) of ``stage``'s twin (``plain``)
    or dispatch on copies of the recorded inputs."""
    args, kwargs = copy(args), copy(kwargs)
    out = stage_fn(stage, plain)(*args, **kwargs)
    return out, (args, kwargs)
