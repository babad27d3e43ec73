"""The plain reference that decides ``correct``: torch and numpy only.

Nothing here imports the program under test; it works from the benchmark's
own inputs (the CSR corpus and query pool of ``apssbench.gen``).
"""

from apssbench.reference.apss import (
    Verdict,
    control_matches,
    judge,
    join_scores,
    query_scores,
    tf32_round,
)

__all__ = ["Verdict", "control_matches", "judge", "join_scores", "query_scores", "tf32_round"]
