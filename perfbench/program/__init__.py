"""How the program under test is given a model of each family, one module
each, found by a model block's `model_type` (`spec.py`)."""
