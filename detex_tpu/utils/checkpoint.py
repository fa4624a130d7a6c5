"""Checkpoint / resume for long control runs.

The reference is a stateless library with no persistence (SURVEY.md §5
checkpoint/resume: absent).  The rebuild checkpoints everything needed
for *deterministic* resume of a control run: dynamics params, optimizer
state, the MPPI nominal control sequence, the PRNG key, and the step
counter, as one npz of the flattened pytree.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import jax
import numpy as np


def controller_state(params, opt_state, nominal, key,
                     step: int) -> Dict[str, Any]:
    return {"params": params, "opt_state": opt_state,
            "nominal": nominal, "key": key,
            "step": np.int64(step)}


def save(path: str, state: Dict[str, Any]) -> None:
    """Save a pytree checkpoint as <path>.npz (+ <path>.tree)."""
    path = Path(path)
    flat, treedef = jax.tree.flatten(state)
    np.savez(path.with_suffix(".npz"),
             *(np.asarray(x) for x in flat))
    (path.with_suffix(".tree")).write_text(json.dumps(str(treedef)))


def restore(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a checkpoint saved by save(); `template` supplies the
    pytree structure."""
    path = Path(path)
    data = np.load(path.with_suffix(".npz"))
    flat_t, treedef = jax.tree.flatten(template)
    flat = [data[f"arr_{i}"] for i in range(len(flat_t))]
    return jax.tree.unflatten(treedef, flat)
