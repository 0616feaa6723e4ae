"""Architecture registry of the LM zoo (a copy of ``repro.configs``): the same
ten ids, aliases and configurations.  `--arch <id>` in the launchers resolves
through here."""

from importlib import import_module

from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg, HybridCfg

ARCH_IDS = [
    "seamless_m4t_large_v2",
    "nemotron_4_15b",
    "mamba2_2_7b",
    "mixtral_8x22b",
    "granite_3_2b",
    "yi_34b",
    "granite_moe_1b_a400m",
    "llava_next_mistral_7b",
    "chatglm3_6b",
    "recurrentgemma_2b",
]

_ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "nemotron-4-15b": "nemotron_4_15b",
    "mamba2-2.7b": "mamba2_2_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-3-2b": "granite_3_2b",
    "yi-34b": "yi_34b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "chatglm3-6b": "chatglm3_6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)


__all__ = [
    "ArchConfig",
    "MoECfg",
    "SSMCfg",
    "HybridCfg",
    "ARCH_IDS",
    "get_config",
    "list_archs",
]
