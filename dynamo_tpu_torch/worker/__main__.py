from dynamo_tpu_torch.worker.main import main

if __name__ == "__main__":
    main()
