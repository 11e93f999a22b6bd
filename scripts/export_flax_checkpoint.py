#!/usr/bin/env python
"""Export a run of the JAX package (flaxdiff_tpu) for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/export_flax_checkpoint.py CHECKPOINT_DIR OUT_DIR [--step N]

Run it where the JAX package is installed. It restores the orbax step
(default: the newest) to host numpy with ``Checkpointer.restore_to_host``,
unflattens a flat-params run with the ``param_template.json`` saved beside
it, and writes into OUT_DIR:

- ``params.npz`` and ``ema_params.npz``: every leaf of the flax parameter
  tree (and of its EMA; the ``{"params": ...}`` variables level the CLI's
  init writes is dropped), keyed by its path joined with "/";
- ``hash_table.npy``: the hash text encoder's table,
  ``jax.random.normal(PRNGKey(0), (vocab, features))``, when the run's
  input config has one (torch cannot redraw it);
- ``pipeline_config.json``, copied.

The port loads the directory with
``flaxdiff_tpu_torch.inference.DiffusionInferencePipeline.from_flax_export``.
The port itself never imports this script or JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield "/".join(prefix + (str(key),)), np.asarray(value, dtype=np.float32)


def export(checkpoint_dir: str, out_dir: str, step=None) -> dict:
    """Write the export; returns {"step": ..., "files": [...]}."""
    from flaxdiff_tpu.inference.pipeline import CONFIG_FILENAME
    from flaxdiff_tpu.inputs import DiffusionInputConfig
    from flaxdiff_tpu.trainer.checkpoints import Checkpointer
    from flaxdiff_tpu.trainer.optim import (TEMPLATE_FILENAME, deserialize_template,
                                            is_flat_params, unflatten_params)

    with open(os.path.join(checkpoint_dir, CONFIG_FILENAME)) as f:
        config = json.load(f)
    ckpt = Checkpointer(checkpoint_dir)
    step = ckpt.latest_step() if step is None else step
    state, _meta = ckpt.restore_to_host(step)
    ckpt.close()
    params, ema = state["params"], state.get("ema_params")
    # a flat-params run saves per-dtype vectors; its template rebuilds the
    # tree (flaxdiff_tpu/inference/pipeline.py:170-189)
    if config.get("flat_params") or is_flat_params(params):
        with open(os.path.join(checkpoint_dir, TEMPLATE_FILENAME)) as f:
            template = deserialize_template(json.load(f))
        params = unflatten_params(template, params)
        if ema is not None and is_flat_params(ema):
            ema = unflatten_params(template, ema)

    # the CLI's init_fn returns flax's variables dict, {"params": tree}
    params, ema = ({"params": t} if t is not None and set(t) != {"params"} else t
                   for t in (params, ema))
    os.makedirs(out_dir, exist_ok=True)
    files = []
    for name, tree in (("params.npz", params), ("ema_params.npz", ema)):
        if tree is not None:
            np.savez(os.path.join(out_dir, name), **dict(_flatten(tree["params"])))
            files.append(name)
    if config.get("input_config"):
        conditions = DiffusionInputConfig.deserialize(config["input_config"]).conditions
        tables = [c.encoder.model.table for c in conditions
                  if c.serialize()["encoder_key"] == "hash"]
        if tables:
            np.save(os.path.join(out_dir, "hash_table.npy"), np.asarray(tables[0], np.float32))
            files.append("hash_table.npy")
    shutil.copyfile(os.path.join(checkpoint_dir, CONFIG_FILENAME),
                    os.path.join(out_dir, CONFIG_FILENAME))
    files.append(CONFIG_FILENAME)
    return {"step": int(step), "files": files}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint_dir", help="the JAX run's checkpoint directory")
    p.add_argument("out_dir", help="where the export is written")
    p.add_argument("--step", type=int, default=None, help="default: the newest step")
    args = p.parse_args(argv)
    print(json.dumps(export(args.checkpoint_dir, args.out_dir, args.step)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
