"""Parameters carried from the reference's trees into the port.

The reference keeps parameters as pytrees of arrays; ``np.asarray`` of each
leaf gives numpy arrays, bf16 leaves as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` does not take.  Such a leaf goes through float32 (every
bf16 value is a float32 value) and back to ``torch.bfloat16`` (exact, since
the float32 value came from a bf16 one): the round trip is bit-exact.

* :func:`lm_params_from_numpy` — the reference's ``transformer.init_params``
  tree (per-layer leaves stacked on a leading layer axis) into a
  :class:`~repro_torch.models.transformer.Transformer`, one block per
  layer slice;
* :func:`tree_from_numpy` — any tree of dicts, lists and arrays (GCN's and
  the recsys models' parameters, which the port keeps as such trees);
* :func:`lm_params_to_numpy` — back: a model as the reference's stacked
  tree of numpy arrays;
* :func:`mlp_params_from_numpy` — the reference's stacked MLP of its GPipe
  demo (``distributed/pipeline.py::stack_mlp_params``) as the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import resolve_device
from ..train.tree import Stacked, tree_map
from .transformer import LMConfig, Transformer


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array as a tensor of the same dtype on ``device``; bf16 arrays
    (``ml_dtypes.bfloat16``) become ``torch.bfloat16`` through float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(resolve_device(device))


def tree_from_numpy(tree, device="cuda"):
    """A tree of dicts and lists with array leaves, each leaf through
    :func:`tensor_from_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def lm_params_from_numpy(tree: dict, cfg: LMConfig,
                         device="cuda") -> Transformer:
    """The reference's LM parameter tree (numpy leaves) as a
    :class:`Transformer` on ``device``: ``embed``, ``ln_f``, ``unembed``
    as they are, and each ``layers`` leaf (L, ...) cut into its L blocks."""
    model = Transformer(cfg, device)
    dev = model.device
    with torch.no_grad():
        model.embed.copy_(tensor_from_numpy(tree["embed"], dev))
        model.ln_f.copy_(tensor_from_numpy(tree["ln_f"], dev))
        model.unembed.copy_(tensor_from_numpy(tree["unembed"], dev))
        layers = tree["layers"]
        for i, blk in enumerate(model.blocks):
            for group in ("attn", "ffn"):
                dst = getattr(blk, group)
                if set(dst) != set(layers[group]):
                    raise ValueError(
                        f"{group} leaves {sorted(layers[group])} do not "
                        f"match the config's {sorted(dst)}")
                for k in dst:
                    dst[k].copy_(tensor_from_numpy(layers[group][k][i], dev))
            blk.ln1.copy_(tensor_from_numpy(layers["ln1"][i], dev))
            blk.ln2.copy_(tensor_from_numpy(layers["ln2"][i], dev))
    return model


def lm_params_to_numpy(model: Transformer) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the reference's stacked
    LM tree (``embed``, ``layers`` with each leaf ``(L, ...)``, ``ln_f``,
    ``unembed``) as numpy arrays on the host.  A bf16 leaf comes back as
    float32 (every bf16 value is one), so the round trip through either
    function is bit-exact; the router stays float32."""
    return tree_map(lambda leaf: (leaf.stack() if isinstance(leaf, Stacked)
                                  else leaf.detach()).cpu().float().numpy(),
                    model)


def mlp_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's ``stack_mlp_params`` tree (numpy ``w`` (L, d, d)
    and ``b`` (L, d)) as the port's, on ``device``."""
    if set(tree) != {"w", "b"}:
        raise ValueError(f"a stacked MLP has leaves w and b, got "
                         f"{sorted(tree)}")
    return {k: tensor_from_numpy(tree[k], device) for k in ("w", "b")}
