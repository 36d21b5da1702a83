"""Hyperparameter search: the native ASHA search and the optuna and ray searches."""
