"""Record-level error routing: retry / skip / fail / dead-letter.

Parity: reference `runtime/agent/StandardErrorsHandler.java` (outcome enum
SKIP|RETRY|FAIL) wired into AgentRunner.java:627-649,856-943.
"""

from __future__ import annotations

import enum
import logging

from langstream_tpu_torch.api.agent import BadRecordError
from langstream_tpu_torch.api.model import ErrorsSpec
from langstream_tpu_torch.api.record import Record

log = logging.getLogger(__name__)


class ErrorsProcessingOutcome(enum.Enum):
    SKIP = "skip"
    RETRY = "retry"
    FAIL = "fail"
    DEAD_LETTER = "dead-letter"


class PermanentFailureError(Exception):
    """Raised when the errors policy says the whole agent must fail."""

    def __init__(self, record: Record, cause: BaseException) -> None:
        super().__init__(f"permanent failure on record: {cause}")
        self.record = record
        self.cause = cause


class StandardErrorsHandler:
    def __init__(self, spec: ErrorsSpec) -> None:
        self.retries = spec.resolved_retries()
        self.on_failure = spec.resolved_on_failure()
        self._failures = 0
        # per-record retry counters keyed by identity
        self._attempts: dict[int, int] = {}

    def handle_error(self, record: Record, error: BaseException) -> ErrorsProcessingOutcome:
        self._failures += 1
        key = id(record)
        attempts = self._attempts.get(key, 0) + 1
        self._attempts[key] = attempts
        retryable = not isinstance(error, BadRecordError)
        if retryable and attempts <= self.retries:
            log.warning(
                "retrying record after error (attempt %d/%d): %s",
                attempts, self.retries, error,
            )
            return ErrorsProcessingOutcome.RETRY
        self._attempts.pop(key, None)
        if self.on_failure == "skip":
            log.warning("skipping record after %d attempts: %s", attempts, error)
            return ErrorsProcessingOutcome.SKIP
        if self.on_failure == "dead-letter":
            log.warning("dead-lettering record after %d attempts: %s", attempts, error)
            return ErrorsProcessingOutcome.DEAD_LETTER
        return ErrorsProcessingOutcome.FAIL

    def forget(self, record: Record) -> None:
        self._attempts.pop(id(record), None)

    @property
    def total_failures(self) -> int:
        return self._failures
