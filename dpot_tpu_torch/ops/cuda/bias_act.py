"""Fused bias + activation + gain + clamp, channels-last: the Hopper kernel
and its gradient.

`bias_act` replaces the TPU kernel `bias_act_pallas`
(dpot_tpu/ops/pallas/bias_act_kernel.py). For a CUDA tensor it launches
`dpot_bias_act` from `dpot_tpu_torch/csrc/bias_act.cu` on the current
stream, or raises; for a CPU tensor it runs `bias_act_ref`
(ops/bias_act.py). `bias_act.launches` counts the calls that launched the
kernel, and a CUDA graph that holds launches adds them at every replay
(ops/cuda/graphs.py). The result has dtype result_type(x, b), as the TPU kernel's, and an
empty input returns without a launch.

Gradient: a `torch.autograd.Function` whose backward differentiates
`bias_act_ref`, with create_graph when the caller asks for it, so that
grad-of-grad works. This mirrors the TPU kernel's custom_jvp, whose tangent
runs through the composition; no main path differentiates this op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dpot_tpu_torch.ops.bias_act import bias_act_ref, resolve

# activation ids of csrc/bias_act.cu
ACT_IDS = {"linear": 0, "relu": 1, "lrelu": 2, "tanh": 3, "sigmoid": 4, "elu": 5,
           "selu": 6, "softplus": 7, "swish": 8}


@functools.cache
def _kernel_fn():
    from dpot_tpu_torch.ops.cuda.build import load_library

    fn = load_library("bias_act").dpot_bias_act
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, i, p, p, p, ctypes.c_longlong, i, f, f, f, p]
    fn.restype = i
    return fn


def _launch(x: torch.Tensor, b, act: str, alpha: float, gain: float,
            clamp: float) -> torch.Tensor:
    """One launch of the kernel on x (N..., C) and b (C,) or None, both of
    the output dtype and contiguous."""
    fn = _kernel_fn()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(
            int(x.dtype == torch.bfloat16), ACT_IDS[act], x.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), x.numel(),
            x.shape[-1], alpha, gain, clamp,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bias_act kernel launch failed: CUDA error {err}")
    bias_act.launches += 1
    return out


def _forward(x, b, act, alpha, gain, clamp) -> torch.Tensor:
    if x.device.type == "cpu":
        return bias_act_ref(x, b, -1, act, alpha, gain, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"bias_act runs on cuda or cpu, not {x.device}")
    out_dtype = torch.result_type(x, b) if b is not None else x.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the bias_act kernel takes float32 or bfloat16, not {out_dtype}")
    if x.numel() == 0:
        return x.to(out_dtype)
    _, alpha, gain, clamp = resolve(act, alpha, gain, clamp)
    return _launch(x.to(out_dtype).contiguous(),
                   None if b is None else b.to(out_dtype).contiguous(),
                   act, alpha, gain, clamp)


class BiasAct(torch.autograd.Function):
    """bias_act with a backward through `bias_act_ref`, itself
    differentiable."""

    @staticmethod
    def forward(ctx, x, b, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.cfg = (act, alpha, gain, clamp)
        return _forward(x, b, act, alpha, gain, clamp)

    @staticmethod
    def backward(ctx, gy):
        x, b = ctx.saved_tensors
        need_x, need_b = ctx.needs_input_grad[:2]
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            xs = x if x.requires_grad else x.detach().requires_grad_(need_x)
            bs = b if b is None or b.requires_grad else b.detach().requires_grad_(need_b)
            y = bias_act_ref(xs, bs, -1, *ctx.cfg)
            inputs = [t for t, need in ((xs, need_x), (bs, need_b)) if need]
            grads = iter(torch.autograd.grad(y, inputs, gy, create_graph=create))
        return (next(grads) if need_x else None, next(grads) if need_b else None,
                None, None, None, None)


def bias_act(x: torch.Tensor, b: torch.Tensor | None = None, act: str = "linear",
             alpha=None, gain=None, clamp=None) -> torch.Tensor:
    """Channels-last x (..., C) + b (C,) or None -> activation -> x gain ->
    clamp. The kernel on a CUDA tensor, `bias_act_ref` on a CPU tensor."""
    resolve(act, alpha, gain, clamp)
    if x.dim() == 0:
        raise ValueError("bias_act needs at least one dimension")
    if b is not None:
        if b.shape != (x.shape[-1],):
            raise ValueError(f"b must be ({x.shape[-1]},), got {tuple(b.shape)}")
        if b.device != x.device:
            raise ValueError(f"b is on {b.device}, x on {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        return BiasAct.apply(x, b, act, alpha, gain, clamp)
    return _forward(x, b, act, alpha, gain, clamp)


bias_act.launches = 0
