"""The port's runtime image recipe (``docker/torch/``), read on the CPU.

The image is neither built nor run here (no docker, no network): these
tests read the recipe. It copies the port and not the JAX package, installs
torch, numpy, grpcio and protobuf and none of the packages the port does
without, builds the kernels at image build, its entry script dispatches
exactly the roles ``langstream_tpu_torch.entrypoint.main`` takes, and its
tag is the image the port's manifests name. JAX's ``docker/Dockerfile``
and ``docker/entrypoint.sh`` are left as they are.
"""

import ast
import re
import shlex
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DOCKERFILE = ROOT / "docker" / "torch" / "Dockerfile"
ENTRY = ROOT / "docker" / "torch" / "entrypoint.sh"
FORBIDDEN = ("jax", "jaxlib", "libtpu", "aiohttp", "pyyaml", "yaml", "click", "bs4",
             "beautifulsoup4", "safetensors")


def instructions() -> list[tuple[str, str]]:
    """The Dockerfile's instructions as (KEYWORD, arguments), comments
    dropped and continuation lines joined."""
    out, buf = [], ""
    for line in DOCKERFILE.read_text().splitlines():
        if line.strip().startswith("#") or not line.strip():
            continue
        buf += line.rstrip("\\").strip() + " "
        if not line.rstrip().endswith("\\"):
            word, _, rest = buf.strip().partition(" ")
            out.append((word.upper(), rest.strip()))
            buf = ""
    return out


def pip_packages() -> list[str]:
    pkgs = []
    for word, args in instructions():
        if word != "RUN":
            continue
        for cmd in args.split("&&"):
            if not cmd.strip().startswith("pip install"):
                continue
            tokens = shlex.split(cmd)
            skip = False
            for tok in tokens[2:]:
                if skip:
                    skip = False
                elif tok in ("--index-url", "-i", "--extra-index-url", "-f"):
                    skip = True
                elif not tok.startswith("-"):
                    pkgs.append(re.split(r"[<>=\[]", tok)[0].lower())
    return pkgs


def entrypoint_roles() -> set[str]:
    """The roles ``entrypoint.main`` dispatches (``role == "..."``)."""
    tree = ast.parse((ROOT / "langstream_tpu_torch" / "entrypoint.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    roles = set()
    for node in ast.walk(main):
        if (isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
                and node.left.id == "role"):
            roles.update(c.value for c in node.comparators if isinstance(c, ast.Constant))
    return roles


def test_recipe_copies_the_port_and_not_the_jax_package():
    copies = [args.split() for word, args in instructions() if word == "COPY"]
    sources = {src for args in copies for src in args[:-1]}
    assert {"langstream_tpu_torch/", "examples/", "docker/torch/entrypoint.sh"} <= sources
    assert not any(s.rstrip("/") in ("langstream_tpu", "native", ".") for s in sources), sources
    assert not any(s.startswith("langstream_tpu/") for s in sources)


def test_recipe_installs_only_what_the_port_imports():
    pkgs = pip_packages()
    assert sorted(pkgs) == ["grpcio", "numpy", "protobuf", "torch"]
    assert not set(pkgs) & set(FORBIDDEN)


def test_recipe_starts_from_a_cuda_devel_base_and_builds_the_kernels():
    steps = instructions()
    args = {w: a for w, a in steps if w == "ARG" and a.startswith("CUDA_IMAGE=")}
    base = args["ARG"].split("=", 1)[1]
    assert base.startswith("nvidia/cuda:") and "-devel-" in base
    assert ("FROM", "${CUDA_IMAGE}") in steps
    runs = [a for w, a in steps if w == "RUN"]
    assert any("langstream_tpu_torch.ops._build import build_all" in r for r in runs)
    # the kernels build after the sources they compile are copied in
    order = [a for w, a in steps if w in ("COPY", "RUN")]
    copy_at = next(i for i, a in enumerate(order) if a.startswith("langstream_tpu_torch/"))
    build_at = next(i for i, a in enumerate(order) if "build_all" in a)
    assert copy_at < build_at
    assert ("ENTRYPOINT", '["/entrypoint.sh"]') in steps


def test_entry_script_dispatches_every_role_of_entrypoint_main():
    text = ENTRY.read_text()
    arms = re.findall(r"^\s*([a-z|-]+)\)\s*$", text, flags=re.M)
    assert len(arms) == 1, arms
    roles = set(arms[0].split("|"))
    assert len(entrypoint_roles()) == 8
    assert roles == entrypoint_roles()
    assert 'exec python -m langstream_tpu_torch.entrypoint "$ROLE" "$@"' in text
    assert "langstream_tpu.entrypoint" not in text and "langstream_tpu.cli" not in text
    assert 'ROLE="${1:-agent-runtime}"' in text


@pytest.mark.parametrize("role", sorted(entrypoint_roles()))
def test_entry_script_runs_each_role_through_the_port(tmp_path, role):
    """Run the script with a stand-in ``python`` on PATH that prints its
    arguments: each role becomes ``python -m langstream_tpu_torch.entrypoint
    <role> <args>``."""
    fake = tmp_path / "python"
    fake.write_text('#!/bin/sh\necho "$@"\n')
    fake.chmod(0o755)
    run = subprocess.run(["sh", str(ENTRY), role, "--x", "1"], capture_output=True, text=True,
                         env={"PATH": f"{tmp_path}:/usr/bin:/bin"}, timeout=30)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["-m", "langstream_tpu_torch.entrypoint", role, "--x", "1"]


def test_image_name_is_the_manifests_default():
    from langstream_tpu_torch.k8s.resources import AgentResourceUnitConfiguration

    image = AgentResourceUnitConfiguration().runtime_image
    assert image == "langstream-tpu-torch/runtime:latest"
    assert f"docker build -f docker/torch/Dockerfile -t {image} ." in DOCKERFILE.read_text()
