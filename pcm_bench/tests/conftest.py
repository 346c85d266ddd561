import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE.parents[1]), str(HERE)):  # the repository root (pcm_bench) and tiny.py
    if p not in sys.path:
        sys.path.insert(0, p)
