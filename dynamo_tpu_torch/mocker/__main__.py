"""`python -m dynamo_tpu_torch.mocker` — mocker engine worker.

Port of `dynamo_tpu/mocker/__main__.py`: an alias of `python -m
dynamo_tpu_torch.worker --mock`.

Reference: `components/src/dynamo/mocker/main.py`.
"""

import sys

from dynamo_tpu_torch.worker.main import main

if __name__ == "__main__":
    main(["--mock", *sys.argv[1:]])
