"""facade.self_host_ms (ms, program span): host time per analysis of the
facade's own spans, ``facade.load_attributes`` and ``facade.run_pipeline``,
outside their child spans (``neighborhoods.*``, ``enrichment.*`` and
``facade.wait``): the facade's passes around the pipeline, a
``cudaMemGetInfo`` included. From the profiled sessions of device ops
alone (``portbench.spans``)."""

from portbench import spans


def read(ctx):
    return spans.read(("facade.load_attributes", "facade.run_pipeline"),
                      "self_host_ms")
