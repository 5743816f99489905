"""Partial ``state_dict`` loading.

Counterpart of ``havatar_tpu/checkpoints/partial.py`` (the reference's
``load_partial_state_dict``): take every entry of a source ``state_dict``
whose key exists in the target with the same shape, skip mismatches and
exclusions; used to load a trainer's weights without its ``latent_codes``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch


def merge_partial(target: Mapping[str, torch.Tensor],
                  source: Mapping[str, torch.Tensor],
                  except_paths: Iterable[str] = ()
                  ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """``target`` (a ``state_dict``) with every entry replaced by
    ``source``'s where the key exists there with the same shape and no
    ``except_paths`` substring occurs in it. Returns (merged, loaded keys,
    skipped keys); ``module.load_state_dict(merged)`` applies it."""
    except_paths = tuple(except_paths)
    merged, loaded, skipped = dict(target), [], []
    for k, v in target.items():
        src = source.get(k)
        if (any(e in k for e in except_paths) or src is None
                or tuple(src.shape) != tuple(v.shape)):
            skipped.append(k)
            continue
        merged[k] = src
        loaded.append(k)
    return merged, loaded, skipped
