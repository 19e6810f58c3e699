"""The program's Mamba2 trunk as the engine's denoiser, through
``repro_torch.diffusion.dit.wrapper_apply``, at the widths of a ``mamba2``
configuration file."""
from __future__ import annotations

import dataclasses


def sample_shape(conf: dict):
    return conf["tokens"], conf["latent_dim"]


def program_arch(conf: dict):
    """The program's ``ArchConfig``: its registry entry with every size the
    file states."""
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(
        get_arch(conf["program_arch"]), num_layers=conf["n_layer"],
        d_model=conf["d_model"], vocab_size=conf["vocab_size"],
        ssm_state=conf["d_state"], ssm_conv_width=conf["d_conv"],
        ssm_expand=conf["expand"], ssm_head_dim=conf["headdim"],
        ssm_ngroups=conf["ngroups"], ssm_chunk=conf["chunk_size"],
        tie_embeddings=conf["tie_embeddings"])


def param_defs(conf: dict):
    from repro_torch.diffusion.dit import wrapper_defs

    return wrapper_defs(program_arch(conf), conf["latent_dim"])


def make_eps_apply(conf: dict):
    """(params, x (n, tokens, latent), taus (n,), labels) -> eps; the
    trunk takes no label."""
    from repro_torch.diffusion.dit import wrapper_apply

    cfg = program_arch(conf)

    def eps_apply(params, x, taus, labels):
        return wrapper_apply(params, cfg, x, taus)
    return eps_apply
