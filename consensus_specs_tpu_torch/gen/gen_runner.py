"""Vector-generation driver (reference capability:
gen_helpers/gen_base/gen_runner.py:41-235).

Lifecycle per case directory:
  1. mkdir + write INCOMPLETE tag
  2. run the case fn, writing yaml ('data'), ssz_snappy ('ssz') parts and
     collecting 'meta' parts into meta.yaml
  3. on success remove INCOMPLETE; on SkippedTest remove the directory;
     on error log to testgen_error_log.txt and leave INCOMPLETE behind
Resume semantics: existing complete cases are skipped unless --force;
INCOMPLETE-tagged cases are wiped and regenerated.

The specs the cases run on are built for one device, ``-d/--device`` or
the ``device`` argument: None (the default) is the CUDA card, and a host
without one raises before any case runs; ``cpu`` must be asked for.  The
YAML parts are written by ``vector_yaml``, byte for byte what the
reference's PyYAML writer gives.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
import traceback
from pathlib import Path
from typing import Any, Iterable

from consensus_specs_tpu_torch._device import resolve_device
from consensus_specs_tpu_torch.testing import context
from consensus_specs_tpu_torch.testing.exceptions import SkippedTest

from . import vector_yaml
from .gen_typing import TestProvider
from .snappy import compress

TIME_THRESHOLD_TO_PRINT = 1.0  # seconds
# what run_generator counts, in the dict it returns
COUNTS = ("collected", "generated", "skipped", "failed")


def validate_output_dir(path_str: str) -> Path:
    path = Path(path_str)
    if not path.exists():
        raise argparse.ArgumentTypeError("Output directory must exist")
    if not path.is_dir():
        raise argparse.ArgumentTypeError("Output path must lead to a directory")
    return path


def _dump_yaml(data: Any, path: Path, file_mode: str) -> None:
    with path.open(file_mode) as f:
        f.write(vector_yaml.dump(data))


def run_generator(generator_name: str,
                  test_providers: Iterable[TestProvider],
                  argv=None, device=None) -> dict:
    """Generate the providers' cases; returns the counts of cases
    ``collected``, ``generated``, ``skipped`` and ``failed`` (a failed case
    is left ``INCOMPLETE`` and logged)."""
    parser = argparse.ArgumentParser(
        prog="gen-" + generator_name,
        description=f"Generate YAML test suite files for {generator_name}",
    )
    parser.add_argument("-o", "--output-dir", dest="output_dir", required=True,
                        type=validate_output_dir,
                        help="directory for the generated vector files")
    parser.add_argument("-f", "--force", action="store_true", default=False,
                        help="regenerate and overwrite existing test files")
    parser.add_argument("-l", "--preset-list", dest="preset_list", nargs="*",
                        type=str, required=False,
                        help="restrict generation to these presets")
    parser.add_argument("-c", "--collect-only", action="store_true", default=False,
                        help="only print the tests that would be generated")
    parser.add_argument("-d", "--device", default=None,
                        help="device the specs are built for (default: the "
                             "CUDA card; 'cpu' runs on the host)")
    args = parser.parse_args(argv)
    if args.device is not None:
        device = args.device
    resolve_device(device)  # no card and no device named: raise here

    # generator mode: skips must raise SkippedTest, not call pytest.skip
    context.is_pytest = False
    previous_device = context.set_spec_device(device)
    try:
        return _generate(generator_name, test_providers, args)
    finally:
        context.set_spec_device(previous_device)


def _generate(generator_name: str, test_providers: Iterable[TestProvider],
              args) -> dict:
    output_dir: Path = args.output_dir
    file_mode = "w" if args.force else "x"
    log_file = output_dir / "testgen_error_log.txt"

    print(f"Generating tests into {output_dir}")
    print(f"Error log file: {log_file}")

    presets = args.preset_list or []
    if presets:
        print(f"Filtering to presets: {', '.join(presets)}")

    collected = generated = skipped = failed = 0
    t_start = time.time()

    for tprov in test_providers:
        if not args.collect_only:
            tprov.prepare()
        for test_case in tprov.make_cases():
            if presets and test_case.preset_name not in presets:
                continue
            case_dir = (
                output_dir / test_case.preset_name / test_case.fork_name
                / test_case.runner_name / test_case.handler_name
                / test_case.suite_name / test_case.case_name
            )
            incomplete_tag = case_dir / "INCOMPLETE"
            collected += 1
            if args.collect_only:
                print(f"Collected test at: {case_dir}")
                continue

            if case_dir.exists():
                if not args.force and not incomplete_tag.exists():
                    skipped += 1
                    continue
                shutil.rmtree(case_dir)  # regenerate (forced or incomplete)

            print(f"Generating test: {case_dir}")
            t_case = time.time()
            case_dir.mkdir(parents=True, exist_ok=True)
            with incomplete_tag.open("w") as f:
                f.write("\n")

            written_part = False
            try:
                meta = {}
                try:
                    for (name, out_kind, data) in test_case.case_fn():
                        written_part = True
                        if out_kind == "meta":
                            meta[name] = data
                        elif out_kind == "data":
                            _dump_yaml(data, case_dir / f"{name}.yaml", file_mode)
                        elif out_kind == "ssz":
                            with (case_dir / f"{name}.ssz_snappy").open(
                                file_mode + "b"
                            ) as f:
                                f.write(compress(data))
                        else:
                            raise ValueError(f"unknown part kind {out_kind!r}")
                except SkippedTest as e:
                    print(e)
                    skipped += 1
                    shutil.rmtree(case_dir)
                    continue

                if meta:
                    written_part = True
                    _dump_yaml(meta, case_dir / "meta.yaml", file_mode)

                if not written_part:
                    print(f"test case {case_dir} did not produce any parts")
            except Exception as e:
                failed += 1
                print(f"ERROR: failed to generate vector(s) for {case_dir}: {e}")
                traceback.print_exc()
                with log_file.open("a+") as f:
                    f.write(f"ERROR: failed to generate vector(s) for {case_dir}: {e}\n")
                    traceback.print_exc(file=f)
                    f.write("\n")
            else:
                if not written_part:
                    shutil.rmtree(case_dir)
                else:
                    generated += 1
                    os.remove(incomplete_tag)
            span = round(time.time() - t_case, 2)
            if span > TIME_THRESHOLD_TO_PRINT:
                print(f"    - generated in {span} seconds")

    span = round(time.time() - t_start, 2)
    if args.collect_only:
        print(f"Collected {collected} tests in total")
    else:
        msg = f"completed generation of {generator_name} with {generated} tests"
        msg += f" ({skipped} skipped tests)"
        if span > TIME_THRESHOLD_TO_PRINT:
            msg += f" in {span} seconds"
        print(msg)
    return dict(zip(COUNTS, (collected, generated, skipped, failed)))


def sum_counts(runs) -> dict:
    """The counts of several ``run_generator`` calls, summed."""
    runs = list(runs)
    return {key: sum(run[key] for run in runs) for key in COUNTS}
