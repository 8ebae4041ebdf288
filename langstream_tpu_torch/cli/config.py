"""CLI profiles (the port's own copy of ``langstream_tpu/cli/config.py``, the
same file format at the same place: reference `langstream configure` /
`profiles` commands; config lives at ~/.langstream-tpu/config.json,
overridable with LANGSTREAM_TPU_CONFIG)."""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class Profile:
    webServiceUrl: str = "http://localhost:8090"
    apiGatewayUrl: str = "http://localhost:8091"
    tenant: str = "default"
    token: Optional[str] = None


@dataclass
class CliConfig:
    current_profile: str = "default"
    profiles: dict[str, Profile] = field(default_factory=lambda: {"default": Profile()})

    @property
    def profile(self) -> Profile:
        return self.profiles.get(self.current_profile, Profile())


def config_path() -> Path:
    env = os.environ.get("LANGSTREAM_TPU_CONFIG")
    if env:
        return Path(env)
    return Path.home() / ".langstream-tpu" / "config.json"


def load_config() -> CliConfig:
    path = config_path()
    if not path.exists():
        return CliConfig()
    try:
        data = json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return CliConfig()
    known = {f for f in Profile.__dataclass_fields__}
    profiles = {
        name: Profile(**{k: v for k, v in p.items() if k in known})
        for name, p in data.get("profiles", {}).items()
        if isinstance(p, dict)
    }
    if not profiles:
        profiles = {"default": Profile()}
    return CliConfig(
        current_profile=data.get("current_profile", "default"), profiles=profiles
    )


def save_config(config: CliConfig) -> None:
    path = config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(
            {
                "current_profile": config.current_profile,
                "profiles": {n: asdict(p) for n, p in config.profiles.items()},
            },
            indent=2,
        )
    )
