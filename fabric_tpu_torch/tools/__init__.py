"""Operator tools of the port: serving bundles and their frozen runners
(``export``), the int8 deployment gate (``validate_int8``), importing the
reference's torch checkpoints (``import_torch``), the stage and
train-step attribution with its microbenches (``ablate``,
``ablate_train``), hyperparameter search (``tune``), the data-prep tools
(``band_stats``, ``make_labels``, ``get_data``), the int8 GEMM sweep
(``sweep_int8_matmul``) and the multi-GPU check (``multigpu_check``)."""
