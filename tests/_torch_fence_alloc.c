/* A guard-page CUDA allocator for torch.cuda.memory.CUDAPluggableAllocator:
 * every allocation gets a mapping of its own with an unmapped region on
 * both sides, and is placed against one of them, so that a kernel that
 * reads or writes past the end (CORNETTO_FENCE=after) or before the start
 * (CORNETTO_FENCE=before) of a tensor stops with an illegal-address fault
 * instead of reading a neighbour's bytes.  Sizes are rounded up to 16
 * bytes, so an access that stays inside the 16-byte granule holding the
 * tensor's last byte is not caught.  The memcheck-like check of
 * tests/_torch_ragged_cases.py::install_fence, for cards where
 * compute-sanitizer does not run.  Frees synchronise the context first:
 * a kernel still in flight may use the memory.
 *
 *   cc -O2 -shared -fPIC -I$CUDA_HOME/include _torch_fence_alloc.c \
 *      -L$CUDA_HOME/lib64/stubs -lcuda -o libfence_alloc.so
 */
#include <cuda.h>
#include <pthread.h>
#include <stdlib.h>
#include <string.h>
#include <sys/types.h>

typedef struct Fence {
    CUdeviceptr base, user;
    size_t reserve, mapped;
    CUmemGenericAllocationHandle handle;
    struct Fence *next;
} Fence;

static Fence *live;
static pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
static size_t gran;

void *fence_malloc(ssize_t size, int device, void *stream)
{
    (void)stream;
    CUmemAllocationProp prop;
    memset(&prop, 0, sizeof(prop));
    prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
    prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
    prop.location.id = device;
    const char *mode = getenv("CORNETTO_FENCE");
    const int before = mode && strcmp(mode, "before") == 0;
    Fence *f = (Fence *)calloc(1, sizeof(Fence));
    if (!f)
        return NULL;
    pthread_mutex_lock(&mu);
    if (!gran && cuMemGetAllocationGranularity(
                     &gran, &prop, CU_MEM_ALLOC_GRANULARITY_MINIMUM))
        goto fail;
    size_t need = size > 0 ? ((size_t)size + 15) & ~(size_t)15 : 16;
    f->mapped = (need + gran - 1) / gran * gran;
    f->reserve = f->mapped + 2 * gran;
    if (cuMemAddressReserve(&f->base, f->reserve, 0, 0, 0))
        goto fail;
    if (cuMemCreate(&f->handle, f->mapped, &prop, 0))
        goto fail_reserved;
    if (cuMemMap(f->base + gran, f->mapped, 0, f->handle, 0))
        goto fail_created;
    CUmemAccessDesc acc;
    memset(&acc, 0, sizeof(acc));
    acc.location = prop.location;
    acc.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
    if (cuMemSetAccess(f->base + gran, f->mapped, &acc, 1))
        goto fail_mapped;
    f->user = before ? f->base + gran : f->base + gran + f->mapped - need;
    f->next = live;
    live = f;
    pthread_mutex_unlock(&mu);
    return (void *)f->user;
fail_mapped:
    cuMemUnmap(f->base + gran, f->mapped);
fail_created:
    cuMemRelease(f->handle);
fail_reserved:
    cuMemAddressFree(f->base, f->reserve);
fail:
    pthread_mutex_unlock(&mu);
    free(f);
    return NULL;
}

void fence_free(void *ptr, ssize_t size, int device, void *stream)
{
    (void)size;
    (void)device;
    (void)stream;
    pthread_mutex_lock(&mu);
    Fence **at = &live;
    while (*at && (*at)->user != (CUdeviceptr)ptr)
        at = &(*at)->next;
    Fence *f = *at;
    if (f) {
        *at = f->next;
        cuCtxSynchronize();
        cuMemUnmap(f->base + gran, f->mapped);
        cuMemRelease(f->handle);
        cuMemAddressFree(f->base, f->reserve);
        free(f);
    }
    pthread_mutex_unlock(&mu);
}
