"""The program's DiT (``repro_torch.diffusion.dit.dit_apply``) as the
engine's denoiser, at the widths of a ``dit`` configuration file."""
from __future__ import annotations

import dataclasses


def sample_shape(conf: dict):
    tokens = (conf["input_size"] // conf["patch_size"]) ** 2
    return tokens, conf["patch_size"] ** 2 * conf["in_channels"]


def program_arch(conf: dict):
    """The program's ``ArchConfig`` for this configuration: its registry
    entry with every width the file states."""
    from repro_torch.configs.registry import get_arch

    d, heads = conf["hidden_size"], conf["num_heads"]
    return dataclasses.replace(
        get_arch(conf["program_arch"]), num_layers=conf["depth"],
        d_model=d, num_heads=heads, num_kv_heads=heads, head_dim=d // heads,
        d_ff=int(d * conf["mlp_ratio"]), latent_dim=sample_shape(conf)[1],
        num_classes=conf["num_classes"])


def param_defs(conf: dict):
    from repro_torch.diffusion.dit import dit_defs

    return dit_defs(program_arch(conf))


def make_eps_apply(conf: dict):
    """(params, x (n, tokens, latent), taus (n,), labels (n,)) -> eps."""
    from repro_torch.diffusion.dit import dit_apply

    cfg = program_arch(conf)

    def eps_apply(params, x, taus, labels):
        return dit_apply(params, cfg, x, taus, labels)
    return eps_apply
