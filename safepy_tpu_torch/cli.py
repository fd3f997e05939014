"""Batch command line: SAFE over a whole attribute matrix in one program.

Port of ``safepy_tpu/cli.py``: the network is loaded and its neighborhoods
computed once, and the whole attribute matrix goes through the device
pipeline in one pass; the NES matrix is pickled.

Usage::

    python -m safepy_tpu_torch.cli path/to/attributes.txt [--ini config.ini]
        [--num-permutations 1000] [--output out.p] [--device cuda]
        [--mesh data=1]

``--mesh`` builds a DeviceMesh over an initialized process group (the
caller runs ``torchrun`` or ``init_process_group``, one device a rank):
``'auto'`` puts every rank on an ``attr`` axis (the attribute columns
sharded, the reference CLI's parallelism), ``'data=2,attr=4'`` builds the
named axes (``cli.py:25-40``).
"""

from __future__ import annotations

import argparse
import logging
import pickle
import time


def parse_mesh(spec: str, device_type: str = "cuda"):
    """--mesh spec -> DeviceMesh: 'auto' puts every rank of the process
    group on an 'attr' axis; 'data=2,attr=4' builds the named axes."""
    import torch.distributed as dist

    from safepy_tpu_torch.parallel import make_mesh

    if spec == "auto":
        if not dist.is_initialized():
            raise RuntimeError("--mesh auto needs an initialized process "
                               "group: run under torchrun or call "
                               "torch.distributed.init_process_group first")
        return make_mesh({"attr": dist.get_world_size()},
                         device_type=device_type)
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return make_mesh(axes, device_type=device_type)


def run_safe_batch(path_to_attribute_file: str, path_to_ini_file: str = "",
                   num_permutations: int = 1000, mesh=None, device="cuda"):
    """The full pipeline over the whole attribute matrix; returns the NES
    matrix (``cli.py:42-53``)."""
    from safepy_tpu_torch.safe import SAFE

    sf = SAFE(path_to_ini_file=path_to_ini_file, device=device)
    sf.mesh = mesh
    sf.load_network()
    sf.define_neighborhoods()
    sf.load_attributes(attribute_file=path_to_attribute_file)
    sf.compute_pvalues(num_permutations=num_permutations)
    return sf.nes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run Spatial Analysis of Functional Enrichment (SAFE) on "
                    "the configured network")
    parser.add_argument("path_to_attribute_file", type=str,
                        help="Path to the file containing label-to-attribute "
                             "annotations")
    parser.add_argument("--ini", type=str, default="",
                        help="Path to a SAFE INI configuration file")
    parser.add_argument("--num-permutations", type=int, default=1000)
    parser.add_argument("--mesh", type=str, default=None,
                        help="Device mesh over an initialized process group: "
                             "'auto' (every rank on an 'attr' axis) or "
                             "'data=2,attr=4'")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the session (default cuda)")
    parser.add_argument("--output", type=str, default=None,
                        help="Output pickle path (default: "
                             "<attribute_file>_safe_nes.p)")
    args = parser.parse_args(argv)

    start = time.time()
    mesh = (parse_mesh(args.mesh, "cpu" if args.device == "cpu" else "cuda")
            if args.mesh else None)
    nes = run_safe_batch(args.path_to_attribute_file, args.ini,
                         args.num_permutations, mesh=mesh, device=args.device)

    output_file = args.output or ("%s_safe_nes.p"
                                  % args.path_to_attribute_file)
    logging.info("Saving the results...")
    with open(output_file, "wb") as handle:
        pickle.dump(nes, handle)
    logging.info("Done in %.1f s -> %s" % (time.time() - start, output_file))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
