"""Desc-level analyses over Program descs (no tensors run): the part of
``paddle_tpu/analysis/`` that the serving engine's ``hbm_report``
calls."""
