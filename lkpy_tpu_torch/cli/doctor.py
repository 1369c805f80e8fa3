"""``lkpy-tpu-torch doctor`` environment diagnostics (port of
``lkpy_tpu/cli/doctor.py``; reference: src/lenskit/cli/doctor.py:50).  It
reports torch, its CUDA and the cards where the JAX one reports jax and
``jax.devices()``."""

from __future__ import annotations

import platform
import sys

import click


@click.command("doctor")
@click.option("--full", is_flag=True, help="include device details")
def doctor(full: bool):
    """Inspect the runtime environment."""
    import numpy
    import pandas
    import pyarrow
    import torch

    import lkpy_tpu_torch

    click.echo(f"lkpy-tpu-torch version: {lkpy_tpu_torch.__version__}")
    click.echo(f"python: {sys.version.split()[0]} on {platform.platform()}")
    click.echo(f"torch: {torch.__version__} (CUDA {torch.version.cuda})")
    click.echo(f"numpy: {numpy.__version__}  pandas: {pandas.__version__}  pyarrow: {pyarrow.__version__}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        click.echo(f"devices: {n} (cuda)")
        for i in range(n):
            line = f"  - cuda:{i} {torch.cuda.get_device_name(i)}"
            if full:
                props = torch.cuda.get_device_properties(i)
                line += f", sm_{props.major}{props.minor}, {props.total_memory / 2**30:.1f} GiB, {props.multi_processor_count} SMs"
            click.echo(line)
    else:
        click.echo("devices: 0 (no CUDA device; run with --device cpu)")
    from lkpy_tpu_torch.config import lkpy_tpu_config

    cfg = lkpy_tpu_config()
    click.echo(f"config: mesh data={cfg.parallel.data_axis} model={cfg.parallel.model_axis}")
