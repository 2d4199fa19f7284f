"""Command-line entry point: ``python -m vbmc_tpu_torch <command>``.

Mirrors the reference driver's mode dispatch (`vbmc.m:169-189,369-372`):
``vbmc('test')`` / ``vbmc('defaults')`` / ``vbmc('version')`` / ``vbmc('all')``.

Commands:
  test       run the statistical self-test suite (selftest.py blocks) and
             report pass/fail per block; on the card unless
             ``--device cpu`` is given
  defaults   print the resolved option schema (optionally for a given D)
  version    print the package version
  all        list every user option name
"""

from __future__ import annotations

import dataclasses
import json
import sys


def _cmd_version():
    from vbmc_tpu_torch import __version__
    print(__version__)


def _cmd_defaults(args):
    from vbmc_tpu_torch.options import VBMCOptions
    d = int(args[0]) if args else None
    opts = VBMCOptions()
    if d is None:
        out = {f.name: repr(getattr(opts, f.name))
               for f in dataclasses.fields(opts)}
    else:
        r = opts.resolve(d)
        out = {}
        for f in dataclasses.fields(opts):
            v = getattr(r, f.name)
            out[f.name] = repr(v) if not callable(v) else "<callable(D)>"
    print(json.dumps(out, indent=2))


def _cmd_all():
    from vbmc_tpu_torch.options import VBMCOptions
    for f in dataclasses.fields(VBMCOptions()):
        print(f.name)


def _cmd_test(args):
    """Self-test: the reference's `vbmc('test')` suite (`selftest.py`, the
    targets of `test/runtest_vbmc.m`): ``test [n] [--device cpu]``, the
    first n blocks, on the card unless ``--device`` names another."""
    import time
    from vbmc_tpu_torch import selftest

    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        args = args[:i] + args[i + 2:]
    n = int(args[0]) if args else None
    blocks = selftest._blocks()
    if n is not None:
        blocks = blocks[:n]
    t0 = time.monotonic()
    ok_all = True
    for i, blk in enumerate(blocks):
        r = selftest.run_block(blk, seed=i + 1, device=device)
        ok_all &= r["ok"]
        status = "PASS" if r["ok"] else "FAIL"
        print(f"{status}  {r['name']:18s} |ELBO-lnZ|={r['elbo_err']:.3f} "
              f"RMSE={r['rmse']:.3f} fevals={r['func_count']}")
    print(f"{'PASSED' if ok_all else 'FAILED'} in "
          f"{time.monotonic() - t0:.1f}s")
    return 0 if ok_all else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    cmd, args = argv[0], argv[1:]
    if cmd == "version":
        _cmd_version()
    elif cmd == "defaults":
        _cmd_defaults(args)
    elif cmd == "all":
        _cmd_all()
    elif cmd == "test":
        return _cmd_test(args)
    else:
        print(f"unknown command {cmd!r}; one of: test defaults version all")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
