"""
Schema and configuration file IO, the format chosen by the file's suffix.

Copy of ``lkpy_tpu/schemas.py`` (reference: src/lenskit/schemas/_load.py
``load_model_data``): JSON, TOML and YAML files load into validated pydantic
models, and :func:`dump_model_data` writes them, TOML by its own small
writer (``tomllib`` reads only).
"""

from __future__ import annotations

import json
import tomllib
from os import PathLike
from pathlib import Path
from typing import Any, TypeVar, overload

from pydantic import BaseModel

__all__ = ["load_model_data", "dump_model_data"]

M = TypeVar("M", bound=BaseModel)


@overload
def load_model_data(path: Path | PathLike[str] | str, model: None = None) -> Any: ...
@overload
def load_model_data(path: Path | PathLike[str] | str, model: type[M]) -> M: ...
def load_model_data(path, model=None):
    """
    Load a configuration file (JSON/TOML/YAML by suffix) and optionally
    validate it with a pydantic model.

    Args:
        path: file path; ``.json``, ``.toml``, ``.yaml``/``.yml`` supported.
        model: pydantic model class to validate against, or ``None`` to
            return plain JSON-compatible data.
    """
    path = Path(path)
    text = path.read_text()
    suffix = path.suffix.lower()
    if suffix == ".json":
        if model is not None:
            return model.model_validate_json(text)
        data = json.loads(text)
    elif suffix == ".toml":
        data = tomllib.loads(text)
    elif suffix in (".yaml", ".yml"):
        import yaml

        data = yaml.safe_load(text)
    else:
        raise ValueError(f"unsupported configuration type for {path}")
    if model is None:
        return data
    return model.model_validate(data)


def dump_model_data(data: BaseModel | dict, path: Path | PathLike[str] | str) -> None:
    """Write a model/dict as JSON, TOML, or YAML chosen by ``path`` suffix."""
    path = Path(path)
    if isinstance(data, BaseModel):
        data = data.model_dump(mode="json", exclude_none=True)
    suffix = path.suffix.lower()
    if suffix == ".json":
        path.write_text(json.dumps(data, indent=2) + "\n")
    elif suffix in (".yaml", ".yml"):
        import yaml

        path.write_text(yaml.safe_dump(data, sort_keys=False))
    elif suffix == ".toml":
        path.write_text(_toml_dumps(data))
    else:
        raise ValueError(f"unsupported configuration type for {path}")


def _toml_dumps(data: dict, _prefix: str = "") -> str:
    """Minimal TOML writer for JSON-compatible config dicts (tomllib has no
    dumper and tomli-w is not in the image)."""
    scalars: list[str] = []
    tables: list[str] = []
    for key, val in data.items():
        if val is None:
            # TOML has no null; omit the key (pydantic defaults restore it)
            continue
        k = key if key.replace("_", "").replace("-", "").isalnum() else json.dumps(key)
        if isinstance(val, dict):
            name = f"{_prefix}.{k}" if _prefix else k
            body = _toml_dumps(val, name)
            header = f"[{name}]\n"
            tables.append(header + body if body else header)
        else:
            scalars.append(f"{k} = {_toml_value(val)}\n")
    out = "".join(scalars)
    if scalars and tables:
        out += "\n"
    return out + "\n".join(tables)


def _toml_value(val) -> str:
    if isinstance(val, bool):
        return "true" if val else "false"
    if isinstance(val, (int, float)):
        return repr(val)
    if isinstance(val, str):
        return json.dumps(val)
    if isinstance(val, (list, tuple)):
        return "[" + ", ".join(_toml_value(v) for v in val) + "]"
    if isinstance(val, dict):  # inline table (e.g. list-of-dict entries)
        items = ", ".join(
            f"{json.dumps(k) if not str(k).replace('_', '').replace('-', '').isalnum() else k} = {_toml_value(v)}"
            for k, v in val.items()
            if v is not None
        )
        return "{" + items + "}"
    if val is None:
        raise ValueError("TOML cannot represent null inside arrays")
    raise TypeError(f"unsupported TOML value type {type(val)}")
