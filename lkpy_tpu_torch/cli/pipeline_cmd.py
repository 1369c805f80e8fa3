"""``lkpy-tpu-torch pipeline`` subcommands (port of
``lkpy_tpu/cli/pipeline_cmd.py``; reference: src/lenskit/cli/pipeline/)."""

from __future__ import annotations

import json

import click

from lkpy_tpu_torch.cli.common import parse_params, resolve_model


@click.group("pipeline")
def pipeline():
    """Pipeline configuration commands."""


@pipeline.command("expand")
@click.option("-m", "--model", "model_spec", default=None)
@click.option("-f", "--file", "spec_file", type=click.Path(exists=True), default=None, help="pipeline spec TOML (pipelines/*.toml)")
@click.option("-p", "--param", "params", multiple=True)
@click.option("-n", "--list-length", type=int, default=None)
@click.option("-o", "--output", type=click.Path(), default=None)
def expand(model_spec, spec_file, params, list_length, output):
    """Expand a model spec into a full pipeline config (reference: cli/pipeline/expand)."""
    from lkpy_tpu_torch.pipeline import topn_pipeline

    if spec_file:
        from lkpy_tpu_torch.pipeline.specfile import load_pipeline_file

        pipe = load_pipeline_file(spec_file).build(n=list_length)
    elif model_spec:
        scorer = resolve_model(model_spec, parse_params(params))
        pipe = topn_pipeline(scorer, n=list_length, name=model_spec)
    else:
        raise click.UsageError("one of -m/--model or -f/--file is required")
    cfg = pipe.get_config().model_dump(mode="json", exclude_none=True)
    if output:
        from lkpy_tpu_torch.schemas import dump_model_data

        dump_model_data(cfg, output)
    else:
        click.echo(json.dumps(cfg, indent=2))


@pipeline.command("diagram")
@click.option("-m", "--model", "model_spec", required=True)
def diagram(model_spec):
    """Print a Mermaid diagram of the pipeline (reference: pipeline/_diagram.py)."""
    from lkpy_tpu_torch.pipeline import pipeline_diagram, topn_pipeline

    click.echo(pipeline_diagram(topn_pipeline(resolve_model(model_spec), name=model_spec)))
