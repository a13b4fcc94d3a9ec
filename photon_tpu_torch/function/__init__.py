"""GLM objectives: the optimizer <-> model contract."""
