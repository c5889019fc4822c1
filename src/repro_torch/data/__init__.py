"""Data utilities of the port: row recovery for selections
(``selection._match_rows``) and the default quotas of a labelled problem
(``balanced_quotas``).  The pipeline and selection entry points of
``repro.data`` wait for a later slice."""
from .selection import balanced_quotas

__all__ = ["balanced_quotas"]
