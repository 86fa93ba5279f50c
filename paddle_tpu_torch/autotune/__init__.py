"""The port's autotune layer: so far only the environment overrides of
``knobs`` (the trial overrides and stored winners of
``paddle_tpu/autotune`` wait for that package's port)."""
