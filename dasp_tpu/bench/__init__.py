from .harness import BenchResult, bench_spmv, data_models  # noqa: F401
from .baselines import BCOOBaseline  # noqa: F401
from .suite import SUITE, build_suite, geomean  # noqa: F401
from .record import (append_record, record_from,  # noqa: F401
                     update_baseline)
