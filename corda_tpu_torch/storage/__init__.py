"""Persistent storage engines (the H2/JDBCHashMap role, native-backed)."""
from .kvstore import KvStore, NATIVE_AVAILABLE  # noqa: F401
