"""Spatial sharding over ``torch.distributed`` (BASELINE config 5): image
tiles on a ('data', 'y', 'x') mesh of ranks, halo exchange between
neighbouring tiles, and the sharded serving and training paths."""
