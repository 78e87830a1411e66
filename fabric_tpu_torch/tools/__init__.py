"""Operator tools of the port: serving bundles and their frozen runners
(``export``), the int8 deployment gate (``validate_int8``), the int8
matrix-rate microbench (``ablate_train``) and the multi-GPU check
(``multigpu_check``)."""
