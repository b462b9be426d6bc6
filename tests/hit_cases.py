"""The hit sets of a render, for the hit path's tests on the CPU
(test_torch_hits.py) and on the card (test_torch_kernels.py)."""

import pytest

from rgbd_recon_tpu_torch.ops import hits


def record_hits(render_frame):
    """{"refine": (args, kwargs), "shade": (args, kwargs)} as the render
    ``render_frame()`` called ops.hits.refine_hits and shade_hits (the
    pipeline calls them through the module, so the recorder sees both);
    the calls still run."""
    calls = {}

    def recorder(key, fn):
        def record(*args, **kwargs):
            calls[key] = (args, kwargs)
            return fn(*args, **kwargs)
        return record

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hits, "refine_hits", recorder("refine", hits.refine_hits))
        mp.setattr(hits, "shade_hits", recorder("shade", hits.shade_hits))
        render_frame()
    return calls
