"""Notification side-channel, the port's copy of
``njode_tpu/utils/notifications.py``.

The reference optionally imports a private ``telegram_notifications`` module
and falls back to a print stub (``train.py:24-33``, ``parallel_train.py:19-28``
— in ``extras.py:18`` the import is hard, a quirk consciously fixed here).
Same surface: ``SBM.send_notification(text, files=None, chat_id=None, ...)``.
"""

from __future__ import annotations


class _PrintStub:
    """Fallback used when no telegram_notifications module is installed."""

    @staticmethod
    def send_notification(text=None, files=None, text_for_files=None,
                          chat_id=None, **kwargs):
        print(text)
        if files:
            print(f"[notification files: {files}]")


try:  # pragma: no cover - private module, absent in this environment
    import telegram_notifications as SBM  # type: ignore # noqa: F401
except Exception:
    SBM = _PrintStub()

SEND = False  # reference gates sends on a server env profile (train.py:39-50)
