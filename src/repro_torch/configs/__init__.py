"""Architecture registry: --arch <id> resolution."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, applicable, smoke_config

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "dbrx-132b": "dbrx_132b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-0.6b": "qwen3_0_6b",
    "smollm-360m": "smollm_360m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-1.3b": "mamba2_1_3b",
    "pixtral-12b": "pixtral_12b",
    "contriever-110m": "contriever_110m",
    "bge-reranker-base": "bge_reranker_base",
    "llama3-8b": "llama3_8b",
}

ASSIGNED_ARCHS = list(_MODULES)[:10]
PAPER_ARCHS = list(_MODULES)[10:]


def get_config(name: str) -> ModelConfig:
    import importlib

    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in _MODULES}
