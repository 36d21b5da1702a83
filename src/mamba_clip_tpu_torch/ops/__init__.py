"""Ops: on-device preprocessing and the selective scan (plain and CUDA)."""
