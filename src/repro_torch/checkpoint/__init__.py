from repro_torch.checkpoint.manager import CheckpointManager, atomic_dir

__all__ = ["CheckpointManager", "atomic_dir"]
