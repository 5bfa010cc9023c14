"""Sharding a batch of games over ranks: one process and one device a rank."""
from dgsqp_torch.parallel.mesh import (GamesMesh, convergence_stats, games_mesh,
                                       init_distributed, pad_to_multiple, resolve_devices,
                                       shard_batch, sharded_batch_solve, spawn_ranks)

__all__ = ['GamesMesh', 'convergence_stats', 'games_mesh', 'init_distributed',
           'pad_to_multiple', 'resolve_devices', 'shard_batch', 'sharded_batch_solve',
           'spawn_ranks']
