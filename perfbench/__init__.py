"""The benchmark of sequoia_torch on the H100: `python3 perfbench/run.py`."""
