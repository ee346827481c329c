"""Seeded weights of the files-only alltoall test cell: one scale a
rank, in [0.5, 1.5), from the weights' own generator."""

import torch


def make(config, seed, device, shrink):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    world = config["deployment"]["world"]
    scale = torch.rand((world, 1), generator=gen, device=device)
    return {"scale": scale.add_(0.5)}
