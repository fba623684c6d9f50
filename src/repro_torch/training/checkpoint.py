"""Checkpointing: numpy-archive save/restore of params + optimizer state.

The JAX package's flat-path ``.npz`` format, key for key: a leaf at
``params["groups"]["l0"]["attn"]["wq"]`` is stored under
``params::groups::l0::attn::wq`` (moments under ``opt_m::`` and
``opt_v::``, the optimizer step as ``opt_step``, the training step as
``__step__``), with the JAX package's stacked axes and orientation, so a
checkpoint written by either package loads into the other.  bfloat16
leaves are stored as float32 (numpy has no bfloat16); loading casts each
array to its template leaf's type and device.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import OptState

_SEP = "::"


def _flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v
                in _flatten(tree[key], f"{prefix}{_SEP}{key}").items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return {prefix: t.numpy()}


def save_checkpoint(path: str, params, opt_state: Optional[OptState] = None,
                    step: int = 0, meta: Optional[dict] = None) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    arrays = _flatten(params, "params")
    if opt_state is not None:
        arrays.update(_flatten(opt_state.m, "opt_m"))
        arrays.update(_flatten(opt_state.v, "opt_v"))
        arrays["opt_step"] = opt_state.step.numpy()
    arrays["__step__"] = np.asarray(step)
    np.savez(p, **arrays)
    if meta:
        p.with_suffix(".meta.json").write_text(json.dumps(meta, default=str))


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bfloat16 array written by the JAX package: its raw bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(dtype=like.dtype, device=like.device)


def _unflatten_into(template, flat: dict, prefix: str):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{_SEP}{k}")
                for k in template}
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{prefix}: shape {arr.shape} != "
                         f"{tuple(template.shape)}")
    return _to_tensor(arr, template)


def load_checkpoint(path: str, params_template,
                    opt_template: Optional[OptState] = None,
                    ) -> Tuple[Any, Optional[OptState], int]:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten_into(params_template, flat, "params")
    opt = None
    if opt_template is not None and "opt_step" in flat:
        opt = OptState(
            step=torch.tensor(flat["opt_step"], dtype=torch.int32),
            m=_unflatten_into(opt_template.m, flat, "opt_m"),
            v=_unflatten_into(opt_template.v, flat, "opt_v"))
    return params, opt, int(flat["__step__"])
