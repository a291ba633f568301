"""Cells of the benchmark at sizes the CPU runs in seconds: the cells' own
configuration, traffic and limits files, with the ViT-S preset at 56^2 and
small batches in their place. The CPU runs the program in float32, so a
sound run reads far inside the cells' limits and a fault far outside."""
from __future__ import annotations

import copy
import json
import os

from portbench.spec import HERE, Cell

SMALL = {"reference": "dinov2_dpt", "preset": "depthanything-small", "embed_dim": 384, "depth": 12, "num_heads": 6,
         "mlp_ratio": 4.0, "base_img_size": 518, "out_indices": [2, 5, 8, 11],
         "interpolate_offset": 0.1, "layerscale_init": 1.0, "features": 64,
         "out_channels": [48, 96, 192, 384], "trailing_head_relu": True,
         "interp_to_input": False}


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def infer_cell(res: int = 56) -> Cell:
    config = _json("configs", "dav2-base.json")
    config["model"] = dict(SMALL)
    config["create"]["dtype"] = "float32"
    traffic = {**_json("traffic", "infer-1036.json"), "processing_res": res, "batch_size": 2,
               "pool": 6, "sizes": [[30, 40], [45, 80]], "sample_calls": 2}
    return Cell("tiny-infer", 1, config, traffic, _json("limits", "base-infer-1036.json"), [], [])


def train_cell(source: str = "memory", res: int = 56) -> Cell:
    config = _json("configs", "dad-distill-l2b.json")
    config.update(student=dict(SMALL), teacher=copy.deepcopy(SMALL))
    config["train"].update(batch_size=4, image_size=res, teacher_chunk=2,
                           student_compute_dtype="float32", teacher_dtype="float32",
                           teacher_fused_tail="off")
    traffic = dict(_json("traffic", f"distill-392-{'memory' if source == 'memory' else 'nyu-files'}.json"))
    traffic.update(pool_batches=3)
    if source != "memory":
        traffic.update(file_hw=[48, 64], max_img_s=8)
    limits = _json("limits", f"distill-392{'' if source == 'memory' else '-nyu-files'}.json")
    return Cell("tiny-train", 1, config, traffic, limits, [], [])
