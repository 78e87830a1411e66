"""Operator tools of the port: the int8 deployment gate
(``validate_int8``) and the int8 matrix-rate microbench
(``ablate_train``)."""
