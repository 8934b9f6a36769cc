from repro_torch.checkpoint.manager import CheckpointManager, restore_latest

__all__ = ["CheckpointManager", "restore_latest"]
