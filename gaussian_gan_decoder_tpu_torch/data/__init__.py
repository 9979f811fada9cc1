"""Scene readers of the classic 3DGS pipeline."""
