"""Tiny versions of the benchmark's configurations and cells, for CPU tests:
the same keys, widths cut so that a run takes seconds, float32 compute."""

from __future__ import annotations

import copy

from port_bench.harness.cell import Cell, load_benchmark


def tiny_config(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c["dtype"] = "float32"
    if "unet" in c:
        c["unet"].update(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                         attention_resolutions=[1, 2], num_heads=2, context_dim=32)
        c["first_stage"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1)
        c["text_encoder"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                 num_attention_heads=2)
        c["height"] = c["width"] = 16
        c["sampler"]["steps"] = 6
    else:
        c["model"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                          resolution=16)
        c["data"]["image_size"] = 16
    return c


def tiny_cell(name: str, batch: int = 2) -> Cell:
    cell = Cell(load_benchmark(), name)
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(cell.traffic, batch=min(batch, cell.traffic["batch"]), trace_requests=2)
    cell.traffic["check"] = dict(cell.traffic["check"], requests=2,
                                 **({"rows": 2} if "rows" in cell.traffic["check"] else {}))
    return cell
