"""Carry data across from plain arrays.

The collection plays the part that weights play in a model port: the
tests pull a reference world apart into numpy arrays and rebuild it here,
so both packages index byte-identical data.  Transformer and recsys
weights come across the same way (:func:`transformer_params_from_jax`,
:func:`recsys_params_from_jax`, :func:`mace_params_from_jax`).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lexicon import Lexicon
from repro_torch.data.world import World
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys import param_dtype
from repro_torch.models.transformer import Params, TransformerConfig
from repro_torch.nn.layers import cast_params

_INT_FIELDS = ("n_words", "n_lemmas", "known_cutoff")
_ARRAY_FIELDS = ("lemma1", "lemma2", "lemma_class", "word_probs")


def world_from_arrays(
    lexicon_arrays: Mapping[str, object],
    parts: Sequence[Tuple[np.ndarray, np.ndarray]],
    doc_starts: Sequence[int],
) -> World:
    """The port's :class:`World` from a lexicon's fields (``n_words``,
    ``n_lemmas``, ``known_cutoff``, ``lemma1``, ``lemma2``,
    ``lemma_class``, ``zipf_s``, ``word_probs``) and per-part
    ``(tokens, offsets)`` arrays.  Arrays are copied."""
    missing = set(_INT_FIELDS + _ARRAY_FIELDS + ("zipf_s",)) - set(lexicon_arrays)
    if missing:
        raise ValueError(f"lexicon arrays lack {sorted(missing)}")
    lex = Lexicon(
        **{f: int(lexicon_arrays[f]) for f in _INT_FIELDS},
        **{f: np.array(lexicon_arrays[f]) for f in _ARRAY_FIELDS},
        zipf_s=float(lexicon_arrays["zipf_s"]),
    )
    if len(parts) != len(doc_starts):
        raise ValueError(
            f"{len(parts)} parts but {len(doc_starts)} doc starts"
        )
    return World(
        lexicon=lex,
        parts=[(np.array(t, dtype=np.int64), np.array(o, dtype=np.int64))
               for t, o in parts],
        doc_starts=[int(d) for d in doc_starts],
    )


def transformer_params_from_jax(cfg: TransformerConfig, params_np,
                                device: DeviceLike = None,
                                masters: bool = False) -> Params:
    """The port's transformer parameters from the reference's
    ``init_params`` tree with every leaf turned into a numpy array (the
    same nested dict, the ``block.moe`` subtree included).  For serving,
    every weight is cast to ``cfg.dtype`` once, as the reference casts it
    at each use; with ``masters`` (training) every leaf stays f32, the
    reference's own layout.  Norm gains and the MoE router
    (``block.moe.router.w``, which routes in f32) stay f32 either way."""
    dev = resolve_device(device)
    out = cast_params(params_np, torch.float32 if masters else cfg.dtype, dev)
    moe = out.get("block", {}).get("moe")
    if moe is not None:
        moe["router"] = cast_params(params_np["block"]["moe"]["router"],
                                    torch.float32, dev)
    return out


def recsys_params_from_jax(cfg: Any, params_np, device: DeviceLike = None,
                           masters: bool = False) -> Params:
    """The port's parameters of a recsys arch (any of the four configs)
    from the reference's ``*_init`` tree with every leaf turned into a
    numpy array (the same nested dicts and lists).  For serving, tables
    and dense weights are cast to ``cfg.dtype`` once, as the reference
    casts them at each use; with ``masters`` (training) every leaf stays
    f32, the reference's own layout.  SASRec's norm gains stay f32."""
    return cast_params(params_np, param_dtype(cfg, masters),
                       resolve_device(device))


def mace_params_from_jax(cfg: Any, params_np, device: DeviceLike = None
                         ) -> Params:
    """The port's MACE parameters from the reference's ``mace_init`` tree
    with every leaf turned into a numpy array (the same nested dicts, and
    ``layers`` a list): every leaf f32 whatever ``cfg`` says, as the
    reference keeps them (its equivariant algebra is f32)."""
    return cast_params(params_np, torch.float32, resolve_device(device))
