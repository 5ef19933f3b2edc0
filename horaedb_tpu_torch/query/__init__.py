"""Query layer: SQL front end -> Plan -> interpreters -> executor.

Mirrors the reference's query_frontend / interpreters / query_engine split
(SURVEY §2.1): a hand-rolled SQL parser with the time-series extensions
(TAG columns, TIMESTAMP KEY, ENGINE=, WITH options — ref: parser.rs:140-363
extends sqlparser-rs the same way), a ``Plan`` sum type (ref: plan.rs:67),
interpreters dispatching per plan variant (ref: factory.rs:70), and an
executor that compiles scan+filter+group-by+aggregate plans into the fused
CUDA kernel with a vectorized-numpy fallback for everything else.
"""

from .frontend import Frontend
from .plan import (
    AlterTablePlan,
    CreateTablePlan,
    DescribePlan,
    DropTablePlan,
    ExistsPlan,
    InsertPlan,
    Plan,
    QueryPlan,
    ShowCreatePlan,
    ShowTablesPlan,
)

__all__ = [
    "Frontend",
    "Plan",
    "QueryPlan",
    "InsertPlan",
    "CreateTablePlan",
    "DropTablePlan",
    "DescribePlan",
    "AlterTablePlan",
    "ShowTablesPlan",
    "ShowCreatePlan",
    "ExistsPlan",
]
