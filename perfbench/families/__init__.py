"""Model families, one module each, found by a model block's `model_type`
(`spec.py`)."""
