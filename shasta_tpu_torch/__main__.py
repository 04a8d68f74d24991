"""Command-line driver of the PyTorch/CUDA port.

    python -m shasta_tpu_torch --command assemble --config Nanopore-May2022 \
        --input reads.fasta --assemblyDirectory run [--device cpu]

Counterpart of ``shasta_tpu/__main__.py``, with the reference's command
surface (reference: srcMain/main.cpp:68-76): assemble, explore,
saveBinaryData, cleanupBinaryData, listCommands, listConfigurations,
listConfiguration, createBashCompletionScript. Options use the same
two-tier scheme: a --config (built-in name or conf file) plus
--Section.key value overrides (reference: src/AssemblerOptions.hpp:9-60).
``--device`` says where the alignment DP runs (assemble, and explore's
on-demand alignments): ``cuda`` (the default; raises without a card) or
``cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import os

COMMANDS = [
    "assemble",
    "explore",
    "saveBinaryData",
    "cleanupBinaryData",
    "listCommands",
    "listConfigurations",
    "listConfiguration",
    "createBashCompletionScript",
]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="shasta_tpu_torch",
        description="De novo long read assembler (PyTorch/CUDA)",
    )
    parser.add_argument("--command", default="assemble", choices=COMMANDS)
    parser.add_argument("--input", nargs="*", default=[], help="FASTA/FASTQ input files")
    parser.add_argument(
        "--config", default=None, help="Built-in configuration name or conf file path"
    )
    parser.add_argument(
        "--assemblyDirectory", default="ShastaRun", help="Run directory"
    )
    parser.add_argument("--port", type=int, default=17100, help="explore: HTTP port")
    parser.add_argument(
        "--exploreAccess",
        default="user",
        help="explore: who may connect (user|local|unrestricted)",
    )
    parser.add_argument(
        "--alignmentsPafFile",
        default=None,
        help="explore: PAF of read-to-reference alignments (ground-truth overlay)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="assemble and explore: where the alignment DP runs (cuda|cpu)",
    )
    args, overrides = parser.parse_known_args(argv)

    if args.command == "listCommands":
        for c in COMMANDS:
            print(c)
        return 0

    if args.command == "createBashCompletionScript":
        from shasta_tpu_torch.pipeline.configurations import CONFIGURATIONS

        # reference: srcMain/main.cpp:1390 (createBashCompletionScript)
        script = (
            "#!/bin/bash\n"
            "_shasta_tpu_torch_completion() {\n"
            '    local cur="${COMP_WORDS[COMP_CWORD]}"\n'
            '    local prev="${COMP_WORDS[COMP_CWORD-1]}"\n'
            '    if [[ "$prev" == "--command" ]]; then\n'
            f'        COMPREPLY=($(compgen -W "{" ".join(COMMANDS)}" -- "$cur"))\n'
            '    elif [[ "$prev" == "--config" ]]; then\n'
            f'        COMPREPLY=($(compgen -W "{" ".join(CONFIGURATIONS)}" -- "$cur"))\n'
            "    else\n"
            '        COMPREPLY=($(compgen -W "--command --input --config '
            '--assemblyDirectory --port --device" -- "$cur"))\n'
            "    fi\n"
            "}\n"
            "complete -F _shasta_tpu_torch_completion shasta_tpu_torch\n"
        )
        with open("shasta_tpu_torchCompletion.sh", "w") as f:
            f.write(script)
        print("Wrote shasta_tpu_torchCompletion.sh")
        return 0

    if args.command == "listConfigurations":
        from shasta_tpu_torch.pipeline.configurations import CONFIGURATIONS

        for name in CONFIGURATIONS:
            print(name)
        return 0

    if args.command == "listConfiguration":
        from shasta_tpu_torch.pipeline.configurations import get_configuration

        if not args.config:
            print("Specify --config.", file=sys.stderr)
            return 1
        print(get_configuration(args.config))
        return 0

    if args.command == "assemble":
        return _assemble(args, overrides)

    if args.command == "explore":
        from shasta_tpu_torch.http.explore import run_explorer

        if args.alignmentsPafFile and not os.path.isfile(args.alignmentsPafFile):
            raise SystemExit(f"{args.alignmentsPafFile} not found.")
        run_explorer(
            args.assemblyDirectory,
            port=args.port,
            access=args.exploreAccess,
            paf_file=args.alignmentsPafFile,
            device=args.device,
        )
        return 0

    if args.command == "saveBinaryData":
        src = os.path.join(args.assemblyDirectory, "Data")
        dst = os.path.join(args.assemblyDirectory, "DataOnDisk")
        shutil.copytree(src, dst, dirs_exist_ok=True)
        print(f"Saved {src} -> {dst}")
        return 0

    if args.command == "cleanupBinaryData":
        data = os.path.join(args.assemblyDirectory, "Data")
        disk = os.path.join(args.assemblyDirectory, "DataOnDisk")
        if os.path.isdir(data) and not os.path.islink(data):
            shutil.rmtree(data)
        if os.path.isdir(disk) and not os.path.exists(data):
            os.symlink("DataOnDisk", data)
        print(f"Cleaned up {data}")
        return 0

    print(f"Unknown command {args.command}", file=sys.stderr)
    return 1


def _apply_overrides(config, overrides):
    """--Section.key value pairs (reference CLI style)."""
    i = 0
    while i < len(overrides):
        tok = overrides[i]
        if not tok.startswith("--") or "." not in tok:
            raise SystemExit(f"Unrecognized option {tok!r} (expected --Section.key)")
        section, key = tok[2:].split(".", 1)
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        elif config.is_bool(section, key) and (
            i + 1 >= len(overrides) or overrides[i + 1].startswith("--")
        ):
            # Boolean switch with no value (reference: bool_switch
            # options like --ReadGraph.removeConflicts).
            value = "true"
            i += 1
        else:
            if i + 1 >= len(overrides):
                raise SystemExit(f"Missing value for {tok!r}")
            value = overrides[i + 1]
            i += 2
        config.set(section, key, value)
    return config


def _assemble(args, overrides):
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    if not args.input:
        print("Specify at least one input file with --input.", file=sys.stderr)
        return 1
    # The reference requires --config (srcMain/main.cpp:209-221).
    if not args.config:
        print(
            "Specify --config (a built-in configuration name or a conf file). "
            "Use --command listConfigurations to see built-in names.",
            file=sys.stderr,
        )
        return 1

    config = AssemblyConfig.from_conf_text(get_configuration(args.config))
    _apply_overrides(config, overrides)

    run_dir = args.assemblyDirectory
    if os.path.isdir(run_dir) and os.listdir(run_dir):
        print(
            f"Assembly directory {run_dir} exists and is not empty "
            "(reference behavior: refuse, srcMain/main.cpp:303-324).",
            file=sys.stderr,
        )
        return 1

    summary = run_assembly(args.input, run_dir, config, device=args.device)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except MemoryError:
        # (reference behavior: bad_alloc -> advise a larger machine,
        # srcMain/main.cpp:115-120)
        print(
            "Memory allocation failure. This assembly requires more "
            "memory than available; rerun on a machine with more RAM "
            "or reduce the input size.",
            file=sys.stderr,
        )
        sys.exit(2)
    except KeyboardInterrupt:
        sys.exit(130)
