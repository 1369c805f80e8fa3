"""``lkpy-tpu-torch tune`` (port of ``lkpy_tpu/cli/tune.py``; reference:
src/lenskit/cli/tune.py:76).  Its trials train on the group's ``--device``,
the card unless ``cpu``."""

from __future__ import annotations

import json
from pathlib import Path

import click

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.cli.common import load_dataset
from lkpy_tpu_torch.logging import get_logger

_log = get_logger(__name__)


@click.command("tune")
@click.option("-s", "--spec", "spec_file", type=click.Path(exists=True), required=True, help="TuningSpec JSON/TOML")
@click.option("-o", "--output", type=click.Path(), default=None, help="write results JSON")
@click.option("--test-frac", type=float, default=0.2)
@click.option("--seed", type=int, default=42)
@click.argument("data", type=click.Path(exists=True))
@click.pass_obj
def tune(obj, spec_file, output, test_frac, seed, data):
    """Tune hyperparameters on DATA per a tuning spec."""
    from lkpy_tpu_torch.schemas import load_model_data
    from lkpy_tpu_torch.splitting import SampleFrac, sample_users
    from lkpy_tpu_torch.tuning import PipelineTuner, TuningSpec

    spec_path = Path(spec_file)
    if spec_path.suffix == ".toml":
        # pipelines/*-search.toml spec-file shape (reference:
        # pipelines/als-implicit-search.toml) — [search] + [space.scorer]
        import tomllib

        from lkpy_tpu_torch.pipeline.specfile import load_search_file

        with open(spec_path, "rb") as f:
            spec_data = tomllib.load(f)
        if "search" in spec_data or "space" in spec_data:
            spec = load_search_file(spec_path, data=spec_data)
        else:
            spec = load_model_data(spec_path, TuningSpec)
    else:
        spec = load_model_data(spec_path, TuningSpec)

    ds = load_dataset(data)
    split = sample_users(ds, max(ds.user_count // 5, 1), SampleFrac(test_frac, rng=seed), rng=seed)
    tuner = PipelineTuner(spec, split, rng=seed, device=resolve_device(obj.get("device")))
    results = tuner.run()
    click.echo(f"best {spec.metric}: {results.best_value:.4f}")
    click.echo(f"best params: {json.dumps(results.best_params)}")
    if output:
        with open(output, "w") as f:
            json.dump(
                {
                    "best_params": results.best_params,
                    "best_value": results.best_value,
                    "points": [
                        {"params": p.params, "value": p.value, "epochs": p.epochs, "time": p.time}
                        for p in results.points
                    ],
                },
                f,
                indent=2,
            )
        click.echo(f"results saved to {output}")
