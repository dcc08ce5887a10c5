"""Tiny configurations for the benchmark's CPU tests: the shapes of the
real ones (a tandem array collapsed in the assembly, dispersed repeats,
an organelle at 20 copies, short or long reads), at a size a test
holds.  Its repeats pass 255 at 30x, as the real configurations' do."""

SHORT_READS = {"model": "short", "length": 150, "coverage": 30,
               "substitution_rate": 0.002}
LONG_READS = {"model": "long", "length_mean": 3000, "length_sd": 600,
              "length_min": 1000, "length_max": 5000, "coverage": 30,
              "error_rate": 0.001, "indel_share": 0.5}


def config(reads: dict) -> dict:
    return {
        "generator": "genome_reads", "k": 21,
        "genome": {
            "gc": 0.4,
            "sequences": [{"name": "c1", "length": 60000},
                          {"name": "c2", "length": 30000},
                          {"name": "m", "length": 5000, "gc": 0.2,
                           "copies": 20}],
            "tandem": [{"sequence": "c1", "start": 10000, "unit": 900,
                        "assembly_copies": 2, "genome_copies": 15}],
            "dispersed": [{"name": "rep", "length": 500, "copies": 9}]},
        "assembly": {"errors_per_bp": 0.0005, "line_width": 80},
        "reads": dict(reads)}
