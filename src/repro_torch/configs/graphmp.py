"""The paper's own workload: graph sizes for the GraphMP engine.

``EU2015`` is the paper's largest dataset (1.07B vertices, 91.8B edges);
the distributed dry run (``launch/dryrun.py::lower_graphmp``) reckons the
superstep on fake tensors of its size.  A copy of the reference's table.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkload:
    name: str
    num_vertices: int
    num_edges: int


TWITTER = GraphWorkload("twitter", 42_000_000, 1_500_000_000)
UK2007 = GraphWorkload("uk-2007", 134_000_000, 5_500_000_000)
UK2014 = GraphWorkload("uk-2014", 788_000_000, 47_600_000_000)
EU2015 = GraphWorkload("eu-2015", 1_070_000_000, 91_800_000_000)

WORKLOADS = {w.name: w for w in (TWITTER, UK2007, UK2014, EU2015)}
