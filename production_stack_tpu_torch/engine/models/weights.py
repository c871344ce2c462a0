"""Weights: random init, and parameter trees carried over as numpy arrays.

Counterpart of ``production_stack_tpu/engine/models/weights.py``.  No
checkpoint ships with the repository, so serving boots from a seeded random
init (``load_params`` with ``weights_path=None``); loading HF safetensors
is not ported yet.  ``params_from_numpy`` takes any tree with the JAX
package's layout (``[in, out]`` weights) given as numpy arrays, with no
transposes, which is how the tests hand both packages the same weights;
``lora_params_from_numpy`` does the same for the JAX adapter registry's
slot tree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import lora as lora_lib
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.models import llama


def load_params(
    cfg: ModelConfig,
    weights_path: Optional[str] = None,
    *,
    seed: int = 0,
    device: torch.device,
) -> llama.Params:
    """Seeded random init on ``device`` (a ``torch.Generator`` on that
    device, seeded with ``seed``).  A ``weights_path`` raises: reading
    checkpoints is not ported yet."""
    if weights_path is not None:
        raise NotImplementedError(
            "loading HF safetensors is not ported yet; boot with "
            "weights_path=None (seeded random init)"
        )
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return llama.init_params(cfg, generator, device)


def params_from_numpy(
    cfg: ModelConfig,
    tree,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
) -> llama.Params:
    """The JAX package's parameter tree, as numpy arrays (or anything
    ``np.asarray`` takes), to the port's tensors on ``device``, cast to
    ``dtype`` (default: the model's).  Same keys, same shapes, no
    transposes."""
    dtype = dtype or llama.param_dtype(cfg)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        return torch.tensor(np.asarray(x, dtype=np.float32), dtype=dtype,
                            device=device)

    return convert(tree)


def lora_params_from_numpy(
    cfg: ModelConfig, lora_cfg, tree, device: torch.device
) -> lora_lib.LoraStacks:
    """The JAX adapter registry's slot tree (``{"layers": [{proj: (A [L,
    in, r], B [L, r, out])}], "scale": [L]}`` as numpy arrays, L =
    max_loras + 1) to the port's slot stacks on ``device``, every slot's
    values as they are.  Slot 0 is the base model and holds no columns in
    the port, so its B factors must be zero."""
    stacks = lora_lib.init_lora_params(cfg, lora_cfg, device)
    for li, layer in enumerate(tree["layers"]):
        for proj, (A, B) in layer.items():
            A = np.asarray(A, dtype=np.float32)
            B = np.asarray(B, dtype=np.float32)
            if np.any(B[0]):
                raise ValueError(f"layer {li} {proj}: slot 0 (the base model) "
                                 "has a nonzero B factor")
            for slot in range(1, lora_cfg.num_slots):
                A_dst, B_dst = stacks.views(li, proj, slot)
                A_dst.copy_(torch.tensor(A[slot]))
                B_dst.copy_(torch.tensor(B[slot]))
    stacks.scale.copy_(torch.tensor(np.asarray(tree["scale"], dtype=np.float32)))
    return stacks
