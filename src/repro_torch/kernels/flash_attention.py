"""K2 — blocked online-softmax GQA attention as hand-written CUDA kernels.

``flash_attention(q, k, v, causal=, window=, scale=, kv_len=)`` computes
the function of the plain version ``ref.attention_ref``: q
``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]``, queries at the last ``Sq``
positions of the valid prefix ``kv_len``.  On CPU tensors it runs the
plain version.  On CUDA tensors it launches one route of
``kernels/csrc/flash_attention.cu`` (built by ``_build`` at first use)
or raises; there is no fallback from a kernel to the plain version on
the card.  The route is picked from the dtype and the shapes alone:

* ``"f32"`` — float32 inputs, any ``Sq``: the CUDA-core kernel (float32
  stays off the tensor cores, which would take it only as TF32);
* ``"split"`` — bfloat16 with ``Sq == 1`` (decode): the visible key
  range is cut into ``splits`` ranges planned on the host by
  ``split_plan`` (Python ints only, no device sync); one kernel writes
  an unnormalised float32 partial per range into scratch, a second one
  combines them (plain versions ``ref.attention_partials`` and
  ``ref.combine_splits``);
* ``"tc"`` — every other bfloat16 call (prefill): the tensor-core
  kernel, 128 query rows per block, 64-key tiles through a cp.async
  ring, ``mma.sync`` for both products.

The kernels replace the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` (Pallas, wrapper
``flash_attention``).  Unlike the Pallas kernel they take ``causal``,
``window``, ``kv_len`` and ``scale`` at run time and any ``Sq``, so the
model's prefill and decode both run them.  Inputs may be strided views
(a KV cache ``[B, S, Hkv, D]`` transposed to ``[B, Hkv, S, D]``) as
long as the head dim is contiguous; the bfloat16 routes also need rows
on 16-byte boundaries and copy an input that is not.  What bounds each
route and what its design does about it: the note at the top of the
CUDA source.

``LAUNCHES.count`` goes up by one per call served by a kernel (the
split route's two kernels count once); ``LAUNCHES.routes`` counts the
same calls by route, so a run shows which route served its path.

Training: ``_FlashAttentionFn`` runs the kernel in the forward pass and,
in the backward pass, differentiates the plain version
``ref.attention_ref`` recomputed from the saved q, k, v
(``_grad.plain_backward``); the kernel itself has no backward, as the
Pallas kernel has none.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._counter import LaunchCounter
from ._grad import plain_backward
from ._launch import on_device, raw_stream

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
ROUTES = ("tc", "split", "f32")
_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = LaunchCounter(ROUTES)

# split planning: keys per split, halved (down to the floor) until the
# grid has at least one block per SM of an H100; query heads per block
SPLIT_KEYS, SPLIT_KEYS_MIN, SMS, SPLIT_HEADS = 128, 32, 132, 8

_FNS = {}
_SIGNATURES = {
    # q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, D, kv_len, causal,
    # window, scale, stream
    "flash_attention_f32_launch": ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 9
                                   + [ctypes.c_float, ctypes.c_void_p]),
    "flash_attention_tc_launch": ([ctypes.c_void_p] * 5
                                  + [ctypes.c_int] * 9
                                  + [ctypes.c_float, ctypes.c_void_p]),
    # q, k, v, o, strides, parts, B, Hq, Hkv, Skv, D, kv_len, lo, per,
    # splits, scale, stream
    "flash_attention_split_launch": ([ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 9
                                     + [ctypes.c_float, ctypes.c_void_p]),
    # parts, o, o_b, o_h, splits, B, Hq, D, stream
    "flash_attention_combine_launch": ([ctypes.c_void_p] * 2
                                       + [ctypes.c_longlong] * 2
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p]),
}


def _launcher(name):
    fn = _FNS.get(name)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("flash_attention"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def route_for(dtype, Sq):
    """The kernel route of a CUDA call: ``"f32"``, ``"split"`` or
    ``"tc"`` (see the module docstring)."""
    if dtype == torch.float32:
        return "f32"
    return "split" if Sq == 1 else "tc"


def visible_range(kv_len, window):
    """``(lo, hi)``, inclusive: the keys visible to the last query
    (position ``kv_len - 1``) — the decode step's whole key range."""
    hi = kv_len - 1
    return (max(0, hi - window + 1) if window > 0 else 0), hi


def split_plan(kv_len, window, B, Hkv, Hq):
    """``(lo, per, splits)`` of the split route from Python ints only:
    split ``s`` covers keys ``[lo + s * per, min(lo + (s + 1) * per,
    kv_len))``, and together they partition the visible range.  ``per``
    is ``SPLIT_KEYS``, halved while the grid (``splits`` x ``B * Hkv``
    x the blocks of the GQA group) has fewer than ``SMS`` blocks."""
    lo, hi = visible_range(kv_len, window)
    n = hi - lo + 1
    blocks = B * Hkv * -(-(Hq // Hkv) // SPLIT_HEADS)
    per = SPLIT_KEYS
    while per > SPLIT_KEYS_MIN and blocks * -(-n // per) < SMS:
        per //= 2
    return lo, per, -(-n // per)


def split_bounds(lo, per, splits, kv_len):
    """The ``[start, stop)`` key range of each split of a plan."""
    return [(lo + s * per, min(lo + (s + 1) * per, kv_len))
            for s in range(splits)]


def _check(q, k, v, kv_len, causal=True):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, Hq, Sq, D] and "
                         f"k, v one [B, Hkv, Skv, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         f"Hq not a multiple of Hkv)")
    kv_len = Skv if kv_len is None else int(kv_len)
    # a causal query must sit inside the valid prefix; non-causal queries
    # (cross-attention: a prompt longer than the encoder's tokens) need not
    if not 0 < kv_len <= Skv or (causal and Sq > kv_len):
        raise ValueError(f"flash_attention: need 0 < kv_len <= Skv, and "
                         f"Sq <= kv_len when causal, got Sq={Sq}, "
                         f"kv_len={kv_len}, Skv={Skv}, causal={causal}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: tensors on several devices")
    return kv_len


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")


def _rows16(t):
    """``t`` itself when its head-dim rows start on 16-byte boundaries
    (what the bfloat16 routes' vector copies need), else a contiguous
    copy."""
    s = t.stride()
    if s[3] == 1 and not (t.data_ptr() % 16 or s[0] % 8 or s[1] % 8
                          or s[2] % 8):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(*tensors):
    st = []
    for t in tensors:
        st += t.stride()[:3]
    return (ctypes.c_longlong * 12)(*st)


def _raise_on(err, what, q, k):
    if err != 0:
        raise RuntimeError(f"flash_attention {what} launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")


def _split_scratch(splits, B, Hq, D, device):
    """Scratch of the split route: one float32 buffer holding
    ``o [splits, B, Hq, D]``, then ``m`` and ``l [splits, B, Hq]``."""
    return torch.empty(splits * B * Hq * (D + 2), dtype=torch.float32,
                       device=device)


def _split_views(parts, splits, B, Hq, D):
    """``(o, m, l)``: the views of a split scratch buffer."""
    rows = splits * B * Hq
    return (parts[:rows * D].view(splits, B, Hq, D),
            parts[rows * D:rows * (D + 1)].view(splits, B, Hq),
            parts[rows * (D + 1):].view(splits, B, Hq))


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    kv_len=None):
    """Attention output ``[B, Hq, Sq, D]`` in q's dtype.  ``window > 0``:
    query at position ``p`` sees keys in ``(p - window, p]``;
    ``kv_len``: valid key prefix (default ``Skv``)."""
    kv_len = _check(q, k, v, kv_len, causal)
    window = int(window)
    B, Hq, Sq, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_len=kv_len)
    _check_cuda(q, k, v)
    route = route_for(q.dtype, Sq)
    if route == "f32":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    else:
        q, k, v = (_rows16(t) for t in (q, k, v))
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty(B, Hq, Sq, D, dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, out)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides))
    with on_device(q.device):
        stream = raw_stream(q.device)
        if route == "split":
            lo, per, splits = split_plan(kv_len, window, B, Hkv, Hq)
            parts = _split_scratch(splits, B, Hq, D, q.device)
            err = _launcher("flash_attention_split_launch")(
                *ptrs, parts.data_ptr(), B, Hq, Hkv, Skv, D, kv_len, lo,
                per, splits, float(scale), stream)
        else:
            err = _launcher(f"flash_attention_{route}_launch")(
                *ptrs, B, Hq, Hkv, Sq, Skv, D, kv_len, int(bool(causal)),
                window, float(scale), stream)
    _raise_on(err, route, q, k)
    LAUNCHES.add(route)
    return out


class _FlashAttentionFn(torch.autograd.Function):
    """``kernel(q, k, v, ...)`` in the forward pass (``flash_attention``
    on the model's path; the CPU tests hand it the plain version to check
    the wiring), the gradient of ``ref.attention_ref`` in the backward
    pass.  Arguments: q, k, v, causal, window, scale, kv_len, kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len, kernel):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        kv_len=kv_len)
        return kernel(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        grads = plain_backward("flash_attention_backward_plain",
                               ref.attention_ref, ctx.saved_tensors,
                               ctx.needs_input_grad[:3], grad_out,
                               **ctx.opts)
        return (*grads, None, None, None, None, None)


def split_partials(q, k, v, *, window=0, scale=None, kv_len=None):
    """The split route's first kernel alone, on CUDA bfloat16 decode
    inputs (``Sq == 1``): ``(plan, (o, m, l))`` with the plan of
    ``split_plan`` and the float32 partials ``o [splits, B, Hq, D]``,
    ``m``, ``l [splits, B, Hq]`` (plain version
    ``ref.attention_partials``).  Not counted in ``LAUNCHES``: it checks
    the kernel, it serves no model path."""
    kv_len = _check(q, k, v, kv_len)
    _check_cuda(q, k, v)
    B, Hq, Sq, D = q.shape
    if route_for(q.dtype, Sq) != "split":
        raise ValueError("split_partials: needs bfloat16 with Sq == 1")
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    q, k, v = (_rows16(t) for t in (q, k, v))
    Hkv, Skv = k.shape[1], k.shape[2]
    plan = split_plan(kv_len, int(window), B, Hkv, Hq)
    parts = _split_scratch(plan[2], B, Hq, D, q.device)
    strides = _strides(q, k, v, q)     # no output: o's slot unused
    with on_device(q.device):
        err = _launcher("flash_attention_split_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
            ctypes.addressof(strides), parts.data_ptr(), B, Hq, Hkv, Skv,
            D, kv_len, *plan, float(scale), raw_stream(q.device))
    _raise_on(err, "split", q, k)
    return plan, _split_views(parts, plan[2], B, Hq, D)


def combine_splits(o_parts, m_parts, l_parts):
    """The split route's combine kernel alone: float32 partials
    ``o [splits, B, Hq, D]``, ``m``, ``l [splits, B, Hq]`` on the card
    into a bfloat16 ``[B, Hq, 1, D]`` (plain version
    ``ref.combine_splits``).  Not counted in ``LAUNCHES``."""
    if o_parts.device.type != "cuda":
        raise ValueError(f"combine_splits: no kernel for device "
                         f"{o_parts.device}")
    splits, B, Hq, D = o_parts.shape
    parts = torch.cat([o_parts.reshape(-1), m_parts.reshape(-1),
                       l_parts.reshape(-1)]).float().contiguous()
    out = torch.empty(B, Hq, 1, D, dtype=torch.bfloat16,
                      device=o_parts.device)
    with on_device(out.device):
        err = _launcher("flash_attention_combine_launch")(
            parts.data_ptr(), out.data_ptr(), out.stride(0), out.stride(1),
            splits, B, Hq, D, raw_stream(out.device))
    if err != 0:
        raise RuntimeError(f"flash_attention combine launch failed: CUDA "
                           f"error {err}")
    return out
