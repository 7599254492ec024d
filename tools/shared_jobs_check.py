"""Each job that ``tests/test_torch_import.py`` and
``tests/test_torch_launch_families.py`` run in shared interpreters
(``test_torch_import.run_jobs``), run again in an interpreter of its
own: its exit code and standard output against the shared run's, the
wall-clock figures masked. Prints one line a job and the lines that
differ.

  PYTHONPATH=src:tests python3 tools/shared_jobs_check.py
"""
import re
import sys
import tempfile

CLOCK = re.compile(r"seconds=\S+|\d+(\.\d+)?(e-?\d+)?( ?s\b| tok/s|ms)")


def main() -> int:
    import test_torch_import as ti
    import test_torch_launch_families as tl
    differ = 0
    for mod in (ti, tl):
        groups = mod.job_groups()
        shared = ti.run_jobs(groups, tempfile.mkdtemp())
        alone = ti.run_jobs([{k: v} for g in groups for k, v in g.items()],
                            tempfile.mkdtemp())
        for k, a in shared.items():
            b = alone[k]
            sa, sb = CLOCK.sub("T", a.stdout), CLOCK.sub("T", b.stdout)
            same = sa == sb and a.returncode == b.returncode
            differ += not same
            print(f"{k:24s} exit {a.returncode} / {b.returncode}, "
                  f"{len(a.stdout.splitlines())} lines: "
                  f"{'equal' if same else 'DIFFER'}")
            for x, y in zip(sa.splitlines(), sb.splitlines()):
                if x != y:
                    print(f"    shared: {x}\n    alone:  {y}")
    print(f"{differ} job(s) differ")
    return int(differ > 0)


if __name__ == "__main__":
    sys.exit(main())
