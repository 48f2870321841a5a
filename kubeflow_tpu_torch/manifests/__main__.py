"""``python -m kubeflow_tpu_torch.manifests <prototype> [--param k=v ...]``
prints the prototype's objects: a JSON list by default, or YAML documents
with ``--output yaml`` (needs PyYAML).

A value is read as JSON where it parses (``num_gpus=1``,
``kv_fused_attention=true``, ``command=["python", "x.py"]``) and as a
string otherwise (``model_name=llama-1b``). Pipe the output to ``kubectl
apply -f -`` to deploy.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.manifests.core import (
    PrototypeError,
    all_prototypes,
    generate,
)


def parse_param(text: str) -> tuple[str, object]:
    key, sep, raw = text.partition("=")
    if not sep or not key:
        raise ValueError(f"--param {text!r}: expected key=value")
    try:
        return key, json.loads(raw)
    except ValueError:
        return key, raw


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.manifests",
                                description=__doc__)
    p.add_argument("prototype", choices=sorted(all_prototypes()),
                   help="prototype name")
    p.add_argument("--param", action="append", default=[],
                   metavar="KEY=VALUE", help="prototype parameter")
    p.add_argument("--output", choices=("json", "yaml"), default="json")
    args = p.parse_args(argv)
    try:
        params = dict(parse_param(t) for t in args.param)
        objs = generate(args.prototype, params)
    except (PrototypeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.output == "yaml":
        try:
            import yaml
        except ImportError:
            print("error: --output yaml needs PyYAML; use --output json",
                  file=sys.stderr)
            return 2
        sys.stdout.write(yaml.safe_dump_all(objs, sort_keys=True))
    else:
        print(json.dumps(objs, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
