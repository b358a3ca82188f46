"""K2 — blocked online-softmax GQA attention as a hand-written CUDA kernel.

``flash_attention(q, k, v, causal=, window=, scale=, kv_len=)`` computes
the function of the plain version ``ref.attention_ref``: q
``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]``, queries at the last ``Sq``
positions of the valid prefix ``kv_len``.  On CUDA tensors it launches
``kernels/csrc/flash_attention.cu`` (built by ``_build`` at first use)
or raises; on CPU tensors it runs the plain version.  There is no
fallback from the kernel to the plain version on the card.

The kernel replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` (Pallas, wrapper
``flash_attention``).  Unlike the Pallas kernel it takes ``causal``,
``window``, ``kv_len`` and ``scale`` at run time and any ``Sq`` (decode
has ``Sq = 1``), so the model's prefill and decode both run it.  Inputs
may be strided views (a KV cache ``[B, S, Hkv, D]`` transposed to
``[B, Hkv, S, D]``) as long as the head dim is contiguous.  Bound: the
score and value products at prefill, the KV cache's bytes at decode;
see the note at the top of the CUDA source.

``LAUNCHES`` counts kernel launches, so a run can show that the model's
main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._counter import LaunchCounter

HEAD_DIMS = (16, 32, 64, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = LaunchCounter()

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v, kv_len):
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
    if not Sq <= kv_len <= Skv:
        raise ValueError(f"flash_attention: need Sq <= kv_len <= Skv, got "
                         f"Sq={Sq}, kv_len={kv_len}, Skv={Skv}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: tensors on several devices")
    return kv_len


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    kv_len=None):
    """Attention output ``[B, Hq, Sq, D]`` in q's dtype.  ``window > 0``:
    query at position ``p`` sees keys in ``(p - window, p]``;
    ``kv_len``: valid key prefix (default ``Skv``)."""
    kv_len = _check(q, k, v, kv_len)
    window = int(window)
    B, Hq, Sq, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty(B, Hq, Sq, D, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), ctypes.addressof(strides),
                          _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, kv_len,
                          int(bool(causal)), window, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES.count += 1
    return out
