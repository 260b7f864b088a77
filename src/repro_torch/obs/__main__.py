"""``python -m repro_torch.obs`` — render the scoreboard from JSONL run records
(``repro_torch.obs.report.main``)."""
from .report import main

if __name__ == "__main__":
    main()
