"""Architecture registry: ``get_config(arch_id)`` + the assigned shape set (the port's copy)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "mixtral-8x22b",
    "moonshot-v1-16b-a3b",
    "whisper-tiny",
    "qwen2-72b",
    "qwen1.5-110b",
    "llama3.2-3b",
    "command-r-plus-104b",
    "internvl2-76b",
    "xlstm-125m",
    "jamba-v0.1-52b",
)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def _mod_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_mod_name(arch)}")
    return mod.make_config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_mod_name(arch)}")
    return mod.make_smoke_config()


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """The assignment's skip rules (documented in DESIGN.md §6)."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (assignment rule)"
    return True, ""


def all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for cell in SHAPES:
            ok, why = cell_applicable(cfg, cell)
            yield arch, cfg, cell, ok, why
