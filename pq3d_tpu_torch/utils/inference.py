"""bf16 serving cast; counterpart of ``pq3d_tpu/utils/inference.py``.

``cast_model_bf16`` casts every floating parameter and buffer of a model
to bf16 (norm scales and running statistics included: an f32 one would
promote what follows back to f32) and makes its forward follow JAX's type
promotion; ``cast_batch_bf16`` casts a batch's float32 tensors to bf16 and
leaves integer and bool tensors alone.  Used together, as the JAX
package's ``cast_params_bf16`` and ``cast_batch_bf16`` are, the forward
runs its matmuls in bf16 up to the first place where an f32 tensor meets
a bf16 one.

JAX promotes such a pair to f32 (flax's ``Dense`` promotes input, kernel
and bias to their common type; ``jnp.einsum`` and ``@`` do the same),
where torch's ``linear``, ``layer_norm``, ``einsum`` and ``matmul`` raise.
``JaxPromotion`` runs those four at the promoted type, so the cast model
keeps JAX's f32 islands: the text encoder's projection after the tower's
cast to f32, the prompt cross-attention and everything downstream of it,
the Fourier encoding, the f32 softmax and batch-norm statistics that the
layers compute on purpose.

The stage-1 model (Res16UNet or Swin3D, any layout) takes the same two
calls.  Its other mixed-float meetings need no mode: the sparse convs
and B1 round their operands themselves and return the input's dtype, as
the JAX convs do; the batch norms, the segment pooling's f32 count
contraction and the swin attention's f32 logits promote as torch's
elementwise ops do; the gathers, ``index_add_`` and ``scatter_`` see one
dtype.  Where XLA expands an op into bf16 steps that round one by one
(the mask head's sigmoid, whose attend bits follow), the port does the
same (``models/heads._sigmoid``)."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PROMOTED = {torch.nn.functional.linear, torch._C._nn.linear, F.layer_norm,
             torch.einsum, torch.matmul, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.bmm}


def _float_dtypes(args, out):
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            out.add(a.dtype)
        elif isinstance(a, (list, tuple)):
            _float_dtypes(a, out)
    return out


def _cast(args, dtype):
    if isinstance(args, torch.Tensor):
        return args.to(dtype) if args.is_floating_point() else args
    if isinstance(args, (list, tuple)):
        return type(args)(_cast(a, dtype) for a in args)
    return args


class JaxPromotion(TorchFunctionMode):
    """Inside this mode ``linear``, ``layer_norm``, ``einsum`` and
    ``matmul`` / ``@`` / ``bmm`` given floating tensors of different
    dtypes run them all at the promoted dtype, as jnp and flax do."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTED:
            dtypes = _float_dtypes(list(args) + list(kwargs.values()), set())
            if len(dtypes) > 1:
                dtype = dtypes.pop()
                for d in dtypes:
                    dtype = torch.promote_types(dtype, d)
                args = _cast(args, dtype)
                kwargs = {k: _cast(v, dtype) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def cast_model_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """Cast ``model``'s floating parameters and buffers to bf16 in place
    and set its ``jax_promotion`` (the forward then runs under
    ``JaxPromotion``); returns the model."""
    model.to(torch.bfloat16)
    model.jax_promotion = True
    return model


def cast_batch_bf16(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch with its float32 tensors (nested dicts included) cast to
    bf16; every other entry as it was."""
    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
            return v.to(torch.bfloat16)
        return v
    return cast(batch)
