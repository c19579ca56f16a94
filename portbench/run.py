"""One run of one benchmark cell of the PyTorch/CUDA port, on the CUDA
device of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
result, one JSON object; the numbers compared with the plain reference
are the last lines of standard error.  Exits non-zero, and prints no
result, without enough CUDA devices or without the program's sources.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness
    sys.exit(harness.main(t_start=T_START))
