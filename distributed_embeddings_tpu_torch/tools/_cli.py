"""The shared CLI scaffold of the port's tools (``detlint``,
``graphlint``, ``trace_report``), the port's own copy of
``tools/_cli.py``: one exit-code and ``--json`` contract.

  EXIT_OK        0  clean
  EXIT_FINDINGS  1  unwaived findings
  EXIT_MALFORMED 2  malformed input (baseline, source tree, a program
                    that no longer runs)
  EXIT_STRICT    3  ``--strict``-only escalations (unverifiable
                    findings, stale or expired waivers)
  EXIT_REQUIRE   4  ``--require``-class missing-content failures

``fail(tool, klass, msg)`` prints the uniform ``tool: KLASS: msg``
stderr line and returns the mapped code; ``emit(payload, as_json,
text)`` prints either the JSON payload or the text rendering.
"""

from __future__ import annotations

import argparse
import json
import sys

from typing import Any, Callable, Optional

EXIT_OK = 0
EXIT_FINDINGS = 1
EXIT_MALFORMED = 2
EXIT_STRICT = 3
EXIT_REQUIRE = 4

_CODES = {
    'FINDINGS': EXIT_FINDINGS,
    'MALFORMED': EXIT_MALFORMED,
    'STRICT': EXIT_STRICT,
    'REQUIRE': EXIT_REQUIRE,
}


def make_parser(tool: str, description: str,
                strict_help: Optional[str] = None
                ) -> argparse.ArgumentParser:
  """The uniform parser base: every tool gets ``--json``; tools with a
  strict escalation pass ``strict_help`` to get ``--strict`` with the
  shared exit-3 semantics."""
  ap = argparse.ArgumentParser(
      prog=tool, description=description,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  ap.add_argument('--json', action='store_true',
                  help='emit the result as JSON instead of text')
  if strict_help is not None:
    ap.add_argument('--strict', action='store_true', help=strict_help)
  return ap


def fail(tool: str, klass: str, message: Any) -> int:
  """Print the uniform ``tool: KLASS: message`` stderr line and return
  the contract exit code for ``klass`` (one of FINDINGS / MALFORMED /
  STRICT / REQUIRE)."""
  print(f'{tool}: {klass}: {message}', file=sys.stderr)
  return _CODES[klass]


def emit(payload: Any, as_json: bool,
         text: Optional[Callable[[], str]] = None) -> None:
  """Print the machine payload (``--json``) or the human rendering —
  the same facts either way."""
  if as_json:
    print(json.dumps(payload, indent=2, default=str))
  elif text is not None:
    out = text()
    if out:
      print(out)


def lint_payload(res: Any, **extra: Any) -> dict:
  """The shared ``--json`` shape for the two analysis gates (detlint's
  AST tier and graphlint's IR tier): the same Result fields rendered
  the same way, plus tool-specific ``extra`` keys."""
  return {
      'counts': res.counts,
      'findings': [vars(f) | {'id': f.id} for f in res.findings],
      'unverifiable': [vars(f) | {'id': f.id}
                       for f in res.unverifiable],
      'waived': [f.id for f in res.waived],
      'stale_waivers': res.stale_waivers,
      'expired_waivers': res.expired_waivers,
      **extra,
  }


def finish_lint(tool: str, res: Any, strict: bool) -> int:
  """The shared exit decision for the two analysis gates: unwaived
  findings exit 1, and under ``--strict`` any unverifiable finding,
  stale waiver or expired waiver exits 3 — held HERE so the next
  strict-escalation change cannot drift between the tools."""
  if res.findings:
    return fail(tool, 'FINDINGS',
                f'{len(res.findings)} unwaived finding(s)')
  if strict and (res.unverifiable or res.stale_waivers
                 or res.expired_waivers):
    return fail(
        tool, 'STRICT',
        f'{len(res.unverifiable)} unverifiable finding(s), '
        f'{len(res.stale_waivers)} stale waiver(s) '
        f'{res.stale_waivers}, {len(res.expired_waivers)} expired '
        f'waiver(s) {res.expired_waivers}')
  return EXIT_OK
